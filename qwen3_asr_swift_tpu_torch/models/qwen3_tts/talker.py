"""Qwen3-TTS talker — port of ``qwen3_asr_swift_tpu/models/qwen3_tts/talker.py``.

An autoregressive codec-token decoder: GQA layers with q/k RMSNorm and a
SwiGLU MLP over a stream fed by sums of text-side embeddings (the text
table through a two-layer SiLU projection) and codec-side embeddings
(3072 codes); multimodal RoPE splits each head's frequencies into
sections driven by three position streams (all equal for TTS); a head
over the codec vocabulary.

Prefill and single-step decode run over the port's static KV cache
(``ops/kv_cache.py``, written in place). The talker's cache is float, so
its decode attention is the plain ``sdpa``; packed weights go through
kernel K1 at decode shapes (``ops/quant.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...core.params import _linear, _norm, _normal
from ...ops.attention import NEG_INF, sdpa
from ...ops.kv_cache import KVCache, after_prefill, after_token, init_cache, write_prompt, write_token
from ...ops.nn import linear, rms_norm, silu, swiglu_mlp
from ...ops.rope import _inverse_frequencies, apply_rope
from .config import TalkerConfig


def mrope_angles(positions: torch.Tensor, head_dim: int, sections: Tuple[int, ...],
                 base: float):
    """Multimodal RoPE angles. positions int [3, B, T] (t/h/w streams).

    The head_dim/2 frequencies are split into ``sections`` groups; group g
    takes its rotation position from ``positions[g]``. Returns (cos, sin),
    each fp32 [B, T, head_dim/2]."""
    half = head_dim // 2
    assert sum(sections) == half, f"mrope sections {sections} != half dim {half}"
    inv_freq = _inverse_frequencies(head_dim, base, positions.device)     # [half], cached
    # pos[section_of[f]][..., f] for each frequency f, without a host copy
    pos = torch.cat([positions[g, ..., None].expand(*positions.shape[1:], n)
                     for g, n in enumerate(sections)], dim=-1)              # [B, T, half]
    angles = pos.to(torch.float32) * inv_freq
    return torch.cos(angles), torch.sin(angles)


def init_talker_params(rng: np.random.Generator, cfg: TalkerConfig) -> dict:
    """Random talker weights in the reference's layout, drawn with numpy."""
    h, hd = cfg.hidden_size, cfg.head_dim
    params = {
        "text_embedding": _normal(rng, (cfg.text_vocab_size, cfg.text_hidden_size), 0.02),
        "codec_embedding": _normal(rng, (cfg.codec_vocab_size, h), 0.02),
        "text_projection": {"fc1": _linear(rng, cfg.text_hidden_size, h),
                            "fc2": _linear(rng, h, h)},
        "codec_head": _linear(rng, h, cfg.codec_vocab_size, bias=False),
        "norm": _norm(h, bias=False),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(_layer_params(rng, h, cfg.num_heads, cfg.num_kv_heads, hd,
                                              cfg.intermediate_size))
    return params


def _layer_params(rng, h, num_heads, num_kv_heads, hd, inter) -> dict:
    return {
        "q_proj": _linear(rng, h, num_heads * hd, bias=False),
        "k_proj": _linear(rng, h, num_kv_heads * hd, bias=False),
        "v_proj": _linear(rng, h, num_kv_heads * hd, bias=False),
        "o_proj": _linear(rng, num_heads * hd, h, bias=False),
        "q_norm": _norm(hd, bias=False),
        "k_norm": _norm(hd, bias=False),
        "input_layernorm": _norm(h, bias=False),
        "post_attention_layernorm": _norm(h, bias=False),
        "mlp": {"gate_proj": _linear(rng, h, inter, bias=False),
                "up_proj": _linear(rng, h, inter, bias=False),
                "down_proj": _linear(rng, inter, h, bias=False)},
    }


def embed_text(params, token_ids: torch.Tensor, cfg: TalkerConfig) -> torch.Tensor:
    """Text token ids → projected hidden (table → fc1 → SiLU → fc2)."""
    x = params["text_embedding"][token_ids.long()]
    p = params["text_projection"]
    return linear(silu(linear(x, p["fc1"])), p["fc2"])


def embed_codec(params, token_ids: torch.Tensor) -> torch.Tensor:
    return params["codec_embedding"][token_ids.long()]


def qkv_heads(p, h: torch.Tensor, num_heads: int, num_kv_heads: int, hd: int):
    """q [B, T, Hq, D], k and v [B, T, Hkv, D] from the fused ``qkv_proj``
    (packed trees) or the separate projections."""
    b, t, _ = h.shape
    if "qkv_proj" in p:
        qd, kvd = num_heads * hd, num_kv_heads * hd
        qkv = linear(h, p["qkv_proj"])
        return (qkv[..., :qd].reshape(b, t, num_heads, hd),
                qkv[..., qd:qd + kvd].reshape(b, t, num_kv_heads, hd),
                qkv[..., qd + kvd:].reshape(b, t, num_kv_heads, hd))
    return (linear(h, p["q_proj"]).reshape(b, t, num_heads, hd),
            linear(h, p["k_proj"]).reshape(b, t, num_kv_heads, hd),
            linear(h, p["v_proj"]).reshape(b, t, num_kv_heads, hd))


def _rotated(p, x, cos, sin, cfg: TalkerConfig):
    """The layer's normed input → q [B,Hq,T,D], k, v [B,Hkv,T,D]."""
    h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
    q, k, v = qkv_heads(p, h, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    q = rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps)
    k = rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps)
    return apply_rope(q.transpose(1, 2), cos, sin), apply_rope(k.transpose(1, 2), cos, sin), \
        v.transpose(1, 2)


def _finish_layer(p, x, attn, cfg: TalkerConfig):
    b, _, t, _ = attn.shape
    x = x + linear(attn.transpose(1, 2).reshape(b, t, -1), p["o_proj"])
    h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
    return x + swiglu_mlp(h2, p["mlp"])


def talker_prefill(params, cfg: TalkerConfig, embeds: torch.Tensor, valid: torch.Tensor,
                   cache: KVCache):
    """embeds [B, T, H]; valid [B, T] bool. Returns (logits fp32 [B, T, V],
    hidden [B, T, H], the cache with the prompt at rows [0, T))."""
    b, t, _ = embeds.shape
    positions = (torch.cumsum(valid.to(torch.int32), dim=1) - 1) * valid
    cos, sin = mrope_angles(positions[None].expand(3, b, t), cfg.head_dim, cfg.mrope_sections,
                            cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    rows = torch.arange(t, device=embeds.device)
    allowed = (rows[None, :] <= rows[:, None])[None] & valid[:, None, :]
    mask = torch.where(allowed, 0.0, NEG_INF).to(torch.float32)[:, None]

    x = embeds
    for i, p in enumerate(params["layers"]):
        q, k, v = _rotated(p, x, cos, sin, cfg)
        write_prompt(cache.layers[i], k, v)
        x = _finish_layer(p, x, sdpa(q, k, v, 1.0 / np.sqrt(cfg.head_dim), mask), cfg)
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    logits = linear(x, params["codec_head"]).float()
    return logits, x, after_prefill(cache, valid, t)


def talker_step(params, cfg: TalkerConfig, embeds: torch.Tensor, cache: KVCache):
    """embeds [B, 1, H]. Returns (logits fp32 [B, V], hidden [B, H], the
    advanced cache)."""
    b = embeds.shape[0]
    pos = cache.positions[:, None]
    cos, sin = mrope_angles(pos[None].expand(3, b, 1), cfg.head_dim, cfg.mrope_sections,
                            cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]
    key_ok = cache.valid.clone()
    key_ok[:, cache.cursor] = True
    mask = torch.where(key_ok, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]

    x = embeds
    for i, p in enumerate(params["layers"]):
        q, k, v = _rotated(p, x, cos, sin, cfg)
        layer = write_token(cache.layers[i], k, v, cache.cursor)
        x = _finish_layer(p, x, sdpa(q, layer.k, layer.v, 1.0 / np.sqrt(cfg.head_dim), mask), cfg)
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    logits = linear(x[:, 0], params["codec_head"]).float()
    return logits, x[:, 0], after_token(cache)


def make_talker_cache(cfg: TalkerConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
                      device) -> KVCache:
    return init_cache(cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim, dtype,
                      device=device)
