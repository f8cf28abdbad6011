"""Qwen3 text decoder (GQA + q/k-norm + RoPE) — port of
``qwen3_asr_swift_tpu/models/qwen3_asr/decoder.py``.

Pre-norm layers of [RMSNorm → GQA attention (per-head q/k RMSNorm,
split-half RoPE) → RMSNorm → SwiGLU MLP], final RMSNorm, tied-embedding
LM head, over the static KV cache of ``ops/kv_cache.py`` (written in
place). Packed weights go through kernel K1 at decode shapes
(``ops/quant.py``); an int8 cache is read by kernel K3
(``ops/attention_int8.py``).

Tensor parallelism (``mesh``, trees cut by ``parallel.shard_pytree`` with
the decoder rules): q/k/v hold this rank's heads (Hq/tp, Hkv/tp — the GQA
groups stay whole) and the cache only its kv heads, so attention and K3
run on the local heads; ``o_proj`` and ``down_proj`` are row-parallel (a
sum over tp each); the vocab-sharded table's lookup is summed and the tied
head's logits gathered over tp before any sampler sees them. A tree whose
attention or MLP stayed whole (tp does not divide the kv heads, or the
groups) runs that part replicated, which the local widths tell.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...ops.attention import NEG_INF, sdpa
from ...ops.attention_int8 import decode_attention_int8
from ...ops.kv_cache import (KVCache, after_prefill, after_token, after_token_at, cache_kv,
                             init_cache, write_prompt, write_token, write_token_at)
from ...ops.nn import (embedding_lookup, fuse_qkv_gate_up, linear, out_features, rms_norm,
                       row_linear, swiglu_mlp, table_rows, tied_lm_head, unfuse_qkv_gate_up)
from ...ops.rope import apply_rope, rope_angles
from ...parallel.mesh import QWEN3_DECODER_RULES, shard_pytree, sharded
from .config import TextDecoderConfig


def fuse_for_inference(params, cfg: TextDecoderConfig) -> dict:
    """q/k/v → ``qkv_proj``, gate/up → ``gate_up_proj`` (exact row concat)."""
    return fuse_qkv_gate_up(params)


def unfuse_for_sharding(params, cfg: TextDecoderConfig) -> dict:
    """Exact inverse of :func:`fuse_for_inference`, so the per-projection
    tp rules apply. No-op on an unfused tree."""
    hd = cfg.head_dim
    return unfuse_qkv_gate_up(params, cfg.num_heads * hd, cfg.num_kv_heads * hd)


def shard_decoder(params, cfg: TextDecoderConfig, mesh) -> dict:
    """This rank's shard of a decoder tree by the decoder rules: q/k/v and
    gate/up are unfused so that each projection takes its own rule, and
    re-fused only where tp leaves them whole (dp-only meshes)."""
    layer = r"(.*layers/\d+/)"
    dec = shard_pytree(
        unfuse_for_sharding(params, cfg), mesh, QWEN3_DECODER_RULES,
        heads=((r".*(q_proj|k_proj|v_proj|o_proj)/", cfg.num_kv_heads),),
        ties=(layer + r"(q_proj|k_proj|v_proj|o_proj)/",
              layer + r"mlp/(gate_proj|up_proj|down_proj)/"))
    return fuse_for_inference(dec, cfg) if mesh.tp == 1 else dec


def local_kv_heads(params, cfg: TextDecoderConfig) -> int:
    """The kv heads this rank's tree holds (all of them unless tp cut them)."""
    p = params["layers"][0]
    if "k_proj" not in p:
        return cfg.num_kv_heads
    return out_features(p["k_proj"]) // cfg.head_dim


def tp_parts(params, cfg: TextDecoderConfig, mesh):
    """(attention mesh, MLP mesh, vocab mesh): ``mesh`` where the tree's
    heads / intermediate width / table rows are this rank's shard, else
    None (replicated)."""
    if mesh is None or mesh.tp == 1:
        return None, None, None
    gate = params["layers"][0]["mlp"].get("gate_proj")
    return (sharded(mesh, local_kv_heads(params, cfg), cfg.num_kv_heads),
            None if gate is None else sharded(mesh, out_features(gate), cfg.intermediate_size),
            sharded(mesh, table_rows(params["embed_tokens"]), cfg.vocab_size))


def _qkv(p, h, positions, cfg: TextDecoderConfig):
    """h [B, T, hidden]; positions [B, T] → q [B,Hq,T,D], k, v [B,Hkv,T,D]
    (this rank's heads under tp)."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    if "qkv_proj" in p:
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        qkv = linear(h, p["qkv_proj"])
        q = qkv[..., :nq].reshape(b, t, cfg.num_heads, hd)
        k = qkv[..., nq:nq + nkv].reshape(b, t, cfg.num_kv_heads, hd)
        v = qkv[..., nq + nkv:].reshape(b, t, cfg.num_kv_heads, hd)
    else:
        q = linear(h, p["q_proj"]).reshape(b, t, -1, hd)
        k = linear(h, p["k_proj"]).reshape(b, t, -1, hd)
        v = linear(h, p["v_proj"]).reshape(b, t, -1, hd)
    q = rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps)
    k = rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def prefill(params, cfg: TextDecoderConfig, embeds, valid, cache: KVCache,
            mesh=None) -> Tuple[torch.Tensor, KVCache]:
    """embeds [B, T, hidden] (static prompt layout); valid [B, T] bool.
    Returns (hidden [B, T, hidden] after the final norm, the cache with the
    prompt written at rows [0, T)). With an int8 cache the prompt is
    written quantized, but attention here reads the fresh, unquantized
    k and v — only decode steps read the quantized cache. ``mesh``: the
    tree is this tp rank's shard."""
    attn_mesh, mlp_mesh, _ = tp_parts(params, cfg, mesh)
    b, t, _ = embeds.shape
    positions = (torch.cumsum(valid.to(torch.int32), dim=1) - 1) * valid
    rows = torch.arange(t, device=embeds.device)
    causal = rows[None, :] <= rows[:, None]                    # [T(q), T(k)]
    allowed = causal[None] & valid[:, None, :]
    mask = torch.where(allowed, 0.0, NEG_INF).to(torch.float32)[:, None]

    x = embeds
    for i, p in enumerate(params["layers"]):
        h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
        q, k, v = _qkv(p, h, positions, cfg)
        write_prompt(cache.layers[i], k, v)
        attn = sdpa(q, k, v, 1.0 / np.sqrt(cfg.head_dim), mask)
        x = x + row_linear(attn.transpose(1, 2).reshape(b, t, -1), p["o_proj"], attn_mesh)
        h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
        x = x + swiglu_mlp(h2, p["mlp"], mlp_mesh)
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    return x, after_prefill(cache, valid, t)


def decode_step(params, cfg: TextDecoderConfig, token_ids, cache: KVCache,
                mesh=None, cursor=None) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for every slot. token_ids [B] → (logits fp32
    [B, vocab], the advanced cache). ``mesh``: the tree is this tp rank's
    shard; the logits come back whole on every rank. ``cursor``: the write
    row as a device tensor (int64 [1]), read and advanced on the device in
    place of ``cache.cursor``, which is then left to the caller (a step
    captured as a CUDA graph reads no host integer)."""
    attn_mesh, mlp_mesh, vocab_mesh = tp_parts(params, cfg, mesh)
    b = token_ids.shape[0]
    x = embedding_lookup(params["embed_tokens"], token_ids, cfg.hidden_size,
                         vocab_mesh)[:, None, :]
    positions = cache.positions[:, None]
    # keys: the valid rows plus the row being written this step
    key_ok = cache.valid.clone()
    if cursor is None:
        key_ok[:, cache.cursor] = True
    else:
        key_ok.index_fill_(1, cursor, True)
    mask = None
    if not cache.quantized:
        mask = torch.where(key_ok, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]

    for i, p in enumerate(params["layers"]):
        h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
        q, k, v = _qkv(p, h, positions, cfg)
        layer = (write_token(cache.layers[i], k, v, cache.cursor) if cursor is None
                 else write_token_at(cache.layers[i], k, v, cursor))
        if cache.quantized:
            attn = decode_attention_int8(q, layer.k, layer.k_scale, layer.v, layer.v_scale,
                                         key_ok, out_dtype=x.dtype)
        else:
            k_all, v_all = cache_kv(layer, k.dtype)
            attn = sdpa(q, k_all, v_all, 1.0 / np.sqrt(cfg.head_dim), mask)
        x = x + row_linear(attn.transpose(1, 2).reshape(b, 1, -1), p["o_proj"], attn_mesh)
        h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
        x = x + swiglu_mlp(h2, p["mlp"], mlp_mesh)
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    logits = tied_lm_head(x[:, 0], params["embed_tokens"], vocab_mesh)
    return logits, after_token(cache) if cursor is None else after_token_at(cache, cursor)


def make_cache(cfg: TextDecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device, kv_heads: int = None) -> KVCache:
    """A cache of ``kv_heads`` heads a layer (default: the config's; a tp
    rank's tree passes :func:`local_kv_heads`)."""
    return init_cache(cfg.num_layers, batch, kv_heads or cfg.num_kv_heads, max_len,
                      cfg.head_dim, dtype, device=device)
