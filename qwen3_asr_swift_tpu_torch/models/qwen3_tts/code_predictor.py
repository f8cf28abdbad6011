"""Qwen3-TTS code predictor — port of
``qwen3_asr_swift_tpu/models/qwen3_tts/code_predictor.py``.

Given the talker's hidden state and the frame's codebook-0 token, a small
GQA transformer predicts codebooks 1..15 one after another: a prefill of
``[hidden, code0 embedding]`` at positions 0 and 1, then 14 cached steps,
each with its group's own embedding table and LM head. Every input is
projected from ``embedding_dim`` to the stack's width first when the
config needs it (the 1.7B talker is 2048 wide, the stack 1024).

The 15-group chain is a Python loop of device ops over a fixed 17-row KV
cache; no step reads anything back to the host. Packed linears go through
kernel K1 (``ops/quant.py``); the group heads are dense ``[D, V]``
matmuls, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.params import _linear, _norm, _normal
from ...ops.attention import NEG_INF, sdpa
from ...ops.nn import linear, rms_norm, swiglu_mlp
from ...ops.rope import apply_rope, rope_angles
from ...ops.sampling import SamplingOptions, sample_token
from .config import CodePredictorConfig
from .talker import _layer_params, qkv_heads

MAX_CP_LEN = 17  # prefill 2 + 15 groups


def init_cp_params(rng: np.random.Generator, cfg: CodePredictorConfig) -> dict:
    """Random code-predictor weights in the reference's layout (group
    tables [15, V, embedding_dim], group heads [15, H, V]), drawn with numpy."""
    h, ng = cfg.hidden_size, cfg.num_code_groups - 1
    params = {
        "group_embeds": _normal(rng, (ng, cfg.vocab_size, cfg.embedding_dim), 0.02),
        "lm_heads": _normal(rng, (ng, h, cfg.vocab_size), 0.02),
        "norm": _norm(h, bias=False),
        "layers": [_layer_params(rng, h, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                 cfg.intermediate_size) for _ in range(cfg.num_layers)],
    }
    if cfg.needs_projection:
        params["projection"] = _linear(rng, cfg.embedding_dim, h)
    return params


def _cp_forward(params, cfg: CodePredictorConfig, x, positions, k_caches, v_caches,
                start: int, kv_len: int):
    """The layer stack over x [B, T, embedding_dim] at positions [B, T];
    k_caches/v_caches [L, B, Hkv, MAX_CP_LEN, D], written at row ``start``
    in place. Returns the normed output [B, T, H]."""
    if cfg.needs_projection:
        x = linear(x, params["projection"])
    b, t, _ = x.shape
    hd = cfg.head_dim
    cols = torch.arange(MAX_CP_LEN, device=x.device)[None, None, None, :]
    rows = positions[:, None, :, None]
    mask = torch.where((cols <= rows) & (cols < kv_len), 0.0, NEG_INF).to(torch.float32)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]

    for li, p in enumerate(params["layers"]):
        h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
        q, k, v = qkv_heads(p, h, cfg.num_heads, cfg.num_kv_heads, hd)
        q = rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps)
        k = rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps)
        q = apply_rope(q.transpose(1, 2), cos, sin)
        k = apply_rope(k.transpose(1, 2), cos, sin)
        k_caches[li, :, :, start:start + t] = k.to(k_caches.dtype)
        v_caches[li, :, :, start:start + t] = v.transpose(1, 2).to(v_caches.dtype)
        attn = sdpa(q, k_caches[li], v_caches[li], 1.0 / np.sqrt(hd), mask)
        x = x + linear(attn.transpose(1, 2).reshape(b, t, -1), p["o_proj"])
        h2 = rms_norm(x, p["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
        x = x + swiglu_mlp(h2, p["mlp"])
    return rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)


def cp_prefill(params, cfg: CodePredictorConfig, hidden: torch.Tensor,
               code0_embed: torch.Tensor):
    """The chain's first forward: ``[hidden, code0_embed]`` at positions 0
    and 1. Returns (group-0 logits fp32 [B, V], k_caches, v_caches)."""
    b = hidden.shape[0]
    k_caches = torch.zeros((cfg.num_layers, b, cfg.num_kv_heads, MAX_CP_LEN, cfg.head_dim),
                           dtype=hidden.dtype, device=hidden.device)
    v_caches = torch.zeros_like(k_caches)
    x0 = torch.stack([hidden, code0_embed.to(hidden.dtype)], dim=1)          # [B, 2, H]
    pos0 = torch.arange(2, device=hidden.device)[None].expand(b, 2)
    normed = _cp_forward(params, cfg, x0, pos0, k_caches, v_caches, 0, 2)
    logits0 = torch.matmul(normed[:, 1], params["lm_heads"][0]).float()
    return logits0, k_caches, v_caches


def predict_codebooks(params, cfg: CodePredictorConfig, hidden: torch.Tensor,
                      code0_embed: torch.Tensor, generator: Optional[torch.Generator] = None,
                      temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Complete one frame: hidden [B, H] (the talker's at this frame) and
    code0_embed [B, H] → codes int64 [B, 15] (codebooks 1..15). Temperature
    sampling draws its Gumbel noise from ``generator``."""
    b = hidden.shape[0]
    opts = SamplingOptions(temperature=temperature, top_k=top_k)
    logits, k_caches, v_caches = cp_prefill(params, cfg, hidden, code0_embed)
    code = sample_token(logits, opts, generator)
    codes = [code]
    for g in range(1, cfg.num_code_groups - 1):
        emb = params["group_embeds"][g - 1][code][:, None, :].to(hidden.dtype)
        pos = torch.full((b, 1), g + 1, dtype=torch.int64, device=hidden.device)
        normed = _cp_forward(params, cfg, emb, pos, k_caches, v_caches, g + 1, g + 2)
        logits = torch.matmul(normed[:, 0], params["lm_heads"][g]).float()
        code = sample_token(logits, opts, generator)
        codes.append(code)
    return torch.stack(codes, dim=1)


def embed_all_groups(params, cfg: CodePredictorConfig, codes: torch.Tensor) -> torch.Tensor:
    """Sum of the 15 group embeddings of codes [B, 15] → [B, embedding_dim]
    (the next talker input's codec side; no projection)."""
    ng = cfg.num_code_groups - 1
    groups = torch.arange(ng, device=codes.device)
    return params["group_embeds"][groups[None, :], codes.long()].sum(dim=1)
