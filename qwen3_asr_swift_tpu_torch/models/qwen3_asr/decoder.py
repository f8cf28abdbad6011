"""Qwen3 text decoder (GQA + q/k-norm + RoPE) — port of
``qwen3_asr_swift_tpu/models/qwen3_asr/decoder.py``.

Pre-norm layers of [RMSNorm → GQA attention (per-head q/k RMSNorm,
split-half RoPE) → RMSNorm → SwiGLU MLP], final RMSNorm, tied-embedding
LM head, over the static KV cache of ``ops/kv_cache.py`` (written in
place). Packed weights go through kernel K1 at decode shapes
(``ops/quant.py``); an int8 cache is read by kernel K3
(``ops/attention_int8.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...ops.attention import NEG_INF, sdpa
from ...ops.attention_int8 import decode_attention_int8
from ...ops.kv_cache import (KVCache, after_prefill, after_token, cache_kv,
                             init_cache, write_prompt, write_token)
from ...ops.nn import embedding_lookup, fuse_qkv_gate_up, linear, rms_norm, swiglu_mlp, tied_lm_head
from ...ops.rope import apply_rope, rope_angles
from .config import TextDecoderConfig


def fuse_for_inference(params, cfg: TextDecoderConfig) -> dict:
    """q/k/v → ``qkv_proj``, gate/up → ``gate_up_proj`` (exact row concat)."""
    return fuse_qkv_gate_up(params)


def _qkv(p, h, positions, cfg: TextDecoderConfig):
    """h [B, T, hidden]; positions [B, T] → q [B,Hq,T,D], k, v [B,Hkv,T,D]."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    if "qkv_proj" in p:
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        qkv = linear(h, p["qkv_proj"])
        q = qkv[..., :nq].reshape(b, t, cfg.num_heads, hd)
        k = qkv[..., nq:nq + nkv].reshape(b, t, cfg.num_kv_heads, hd)
        v = qkv[..., nq + nkv:].reshape(b, t, cfg.num_kv_heads, hd)
    else:
        q = linear(h, p["q_proj"]).reshape(b, t, cfg.num_heads, hd)
        k = linear(h, p["k_proj"]).reshape(b, t, cfg.num_kv_heads, hd)
        v = linear(h, p["v_proj"]).reshape(b, t, cfg.num_kv_heads, hd)
    q = rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps)
    k = rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def prefill(params, cfg: TextDecoderConfig, embeds, valid, cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """embeds [B, T, hidden] (static prompt layout); valid [B, T] bool.
    Returns (hidden [B, T, hidden] after the final norm, the cache with the
    prompt written at rows [0, T)). With an int8 cache the prompt is
    written quantized, but attention here reads the fresh, unquantized
    k and v — only decode steps read the quantized cache."""
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
        x = x + linear(attn.transpose(1, 2).reshape(b, t, -1), p["o_proj"])
        h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
        x = x + swiglu_mlp(h2, p["mlp"])
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    return x, after_prefill(cache, valid, t)


def decode_step(params, cfg: TextDecoderConfig, token_ids, cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for every slot. token_ids [B] → (logits fp32
    [B, vocab], the advanced cache)."""
    b = token_ids.shape[0]
    x = embedding_lookup(params["embed_tokens"], token_ids, cfg.hidden_size)[:, None, :]
    positions = cache.positions[:, None]
    # keys: the valid rows plus the row being written this step
    key_ok = cache.valid.clone()
    key_ok[:, cache.cursor] = True
    mask = None
    if not cache.quantized:
        mask = torch.where(key_ok, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]

    for i, p in enumerate(params["layers"]):
        h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
        q, k, v = _qkv(p, h, positions, cfg)
        layer = write_token(cache.layers[i], k, v, cache.cursor)
        if cache.quantized:
            attn = decode_attention_int8(q, layer.k, layer.k_scale, layer.v, layer.v_scale,
                                         key_ok, out_dtype=x.dtype)
        else:
            k_all, v_all = cache_kv(layer, k.dtype)
            attn = sdpa(q, k_all, v_all, 1.0 / np.sqrt(cfg.head_dim), mask)
        x = x + linear(attn.transpose(1, 2).reshape(b, 1, -1), p["o_proj"])
        h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
        x = x + swiglu_mlp(h2, p["mlp"])
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    logits = tied_lm_head(x[:, 0], params["embed_tokens"])
    return logits, after_token(cache)


def make_cache(cfg: TextDecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device) -> KVCache:
    return init_cache(cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim,
                      dtype, device=device)
