"""Shared Qwen2 decoder layer — port of ``qwen3_asr_swift_tpu/ops/qwen2.py``.

CosyVoice3's speech-token LLM (Qwen2.5-0.5B) and VibeVoice's language
backbone (Qwen2-0.5B) are plain HF-Qwen2 stacks: RMSNorm → biased q/k/v
projections → RoPE → GQA SDPA → unbiased o_proj residual → RMSNorm →
SwiGLU MLP residual. Layer params in the reference's tree (HF naming,
kernels ``[in, out]``).
"""

from __future__ import annotations

import math

import torch

from .attention import sdpa
from .nn import acc_dtype, linear, rms_norm, swiglu_mlp
from .rope import apply_rope, rope_angles


def qwen2_decoder_layer(lp, x: torch.Tensor, positions: torch.Tensor, mask, *,
                        num_heads: int, num_kv_heads: int, head_dim: int,
                        rope_theta: float, rms_norm_eps: float, kc=None, vc=None,
                        start: int = 0):
    """One Qwen2 decoder layer.

    x [B, T, H]; positions [B, T] semantic (RoPE) positions; mask additive,
    broadcastable to [B, 1, T, Tk]. With ``kc``/``vc`` ([B, Hkv, Tk, D]),
    this step's K/V are written into them in place at slot ``start`` (a
    host int) and attention reads the whole cache; otherwise the layer
    self-attends within x. Returns x."""
    b, t, _ = x.shape
    hd = head_dim
    h = rms_norm(x, lp["input_layernorm"]["weight"], rms_norm_eps)
    q = linear(h, lp["q_proj"]).reshape(b, t, num_heads, hd)
    k = linear(h, lp["k_proj"]).reshape(b, t, num_kv_heads, hd)
    v = linear(h, lp["v_proj"]).reshape(b, t, num_kv_heads, hd)
    cos, sin = rope_angles(positions, hd, rope_theta, acc_dtype(x.dtype))
    cos, sin = cos[:, None], sin[:, None]
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    v = v.transpose(1, 2)
    if kc is not None:
        kc[:, :, start:start + t] = k.to(kc.dtype)
        vc[:, :, start:start + t] = v.to(vc.dtype)
        a = sdpa(q, kc, vc, 1.0 / math.sqrt(hd), mask)
    else:
        a = sdpa(q, k, v, 1.0 / math.sqrt(hd), mask)
    x = x + linear(a.transpose(1, 2).reshape(b, t, -1), lp["o_proj"])
    h2 = rms_norm(x, lp["post_attention_layernorm"]["weight"], rms_norm_eps)
    return x + swiglu_mlp(h2, lp["mlp"])
