"""Preallocated static-shape KV caches — port of ``qwen3_asr_swift_tpu/ops/kv_cache.py``.

Each layer owns fixed ``[B, Hkv, max_len, D]`` buffers. A prompt is laid
out at static offsets (``prefix | padded audio | suffix``) with a per-row
``valid`` map; invalid rows are masked at attention time, and
``positions`` keeps each row's next RoPE position so position ids stay
contiguous across the gaps. ``cursor`` is the shared write row of decode
steps, a host integer here (it advances by one per step for every slot).

Unlike the reference's immutable arrays, the writes here update the
buffers IN PLACE: ``write_prompt``/``write_token`` mutate the layer they
are given and return it, and ``after_prefill``/``after_token`` mutate
``valid`` and ``positions``. A cache therefore belongs to one generate.

``dtype=torch.int8`` builds a quantized cache with per-slot symmetric
fp32 scales.

Beam search folds its hypotheses into the batch axis: :func:`repeat_cache`
tiles every per-row buffer (scales included) and :func:`gather_cache`
reorders rows into new buffers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch


@dataclasses.dataclass
class LayerKV:
    k: torch.Tensor                         # [B, Hkv, max_len, D]
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # [B, Hkv, max_len] fp32, int8 only
    v_scale: Optional[torch.Tensor] = None


@dataclasses.dataclass
class KVCache:
    layers: List[LayerKV]
    valid: torch.Tensor       # [B, max_len] bool
    positions: torch.Tensor   # [B] int32 — next RoPE position
    cursor: int               # next write row

    @property
    def quantized(self) -> bool:
        return self.layers[0].k_scale is not None


def init_cache(num_layers: int, batch: int, num_kv_heads: int, max_len: int, head_dim: int,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    quant = dtype == torch.int8
    shape = (batch, num_kv_heads, max_len, head_dim)

    def layer():
        if quant:
            return LayerKV(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
                v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device))
        return LayerKV(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    return KVCache(
        layers=[layer() for _ in range(num_layers)],
        valid=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
        positions=torch.zeros((batch,), dtype=torch.int32, device=device),
        cursor=0,
    )


def quantize_kv(x: torch.Tensor):
    """[B, Hkv, T, D] → (int8 codes, fp32 scale [B, Hkv, T]). ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _write(layer: LayerKV, k_new, v_new, offset: int) -> LayerKV:
    t = k_new.shape[2]
    rows = slice(offset, offset + t)
    if layer.k_scale is not None:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        layer.k[:, :, rows] = kq
        layer.v[:, :, rows] = vq
        layer.k_scale[:, :, rows] = ks
        layer.v_scale[:, :, rows] = vs
    else:
        layer.k[:, :, rows] = k_new.to(layer.k.dtype)
        layer.v[:, :, rows] = v_new.to(layer.v.dtype)
    return layer


def write_prompt(layer: LayerKV, k_new, v_new) -> LayerKV:
    """Prefill write of [B, Hkv, T, D] at row 0 (in place)."""
    return _write(layer, k_new, v_new, 0)


def write_token(layer: LayerKV, k_new, v_new, cursor: int) -> LayerKV:
    """Single-token write of [B, Hkv, 1, D] at ``cursor`` (in place)."""
    return _write(layer, k_new, v_new, cursor)


def cache_kv(layer: LayerKV, dtype=torch.bfloat16):
    """Attendable (k, v): int8 caches dequantized, fp caches passed through."""
    if layer.k_scale is None:
        return layer.k, layer.v
    k = layer.k.to(dtype) * layer.k_scale[..., None].to(dtype)
    v = layer.v.to(dtype) * layer.v_scale[..., None].to(dtype)
    return k, v


def after_prefill(cache: KVCache, prompt_valid: torch.Tensor, prompt_len: int) -> KVCache:
    """Mark the prompt rows: prompt_valid [B, prompt_len] bool."""
    cache.valid.zero_()
    cache.valid[:, :prompt_len] = prompt_valid
    cache.positions.copy_(prompt_valid.sum(dim=1).to(torch.int32))
    cache.cursor = prompt_len
    return cache


def after_token(cache: KVCache) -> KVCache:
    cache.valid[:, cache.cursor] = True
    cache.positions += 1
    cache.cursor += 1
    return cache


def _map_rows(cache: KVCache, fn) -> KVCache:
    def opt(t):
        return None if t is None else fn(t)

    return KVCache(
        layers=[LayerKV(fn(l.k), fn(l.v), opt(l.k_scale), opt(l.v_scale)) for l in cache.layers],
        valid=fn(cache.valid), positions=fn(cache.positions), cursor=cache.cursor)


def repeat_cache(cache: KVCache, k: int) -> KVCache:
    """Tile every row K× along the batch axis ([B] → [B·K], beam-major
    within each request); the cursor is shared."""
    return _map_rows(cache, lambda t: torch.repeat_interleave(t, k, dim=0))


def gather_cache(cache: KVCache, rows: torch.Tensor) -> KVCache:
    """Row i of the new cache is row ``rows[i]`` of the old one."""
    return _map_rows(cache, lambda t: t.index_select(0, rows))
