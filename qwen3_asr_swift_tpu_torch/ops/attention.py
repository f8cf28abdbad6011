"""Scaled dot-product attention with GQA — port of ``qwen3_asr_swift_tpu/ops/attention.py``.

Plain tensor math, as the reference's ``sdpa`` is plain XLA: query heads
reshape to ``[kv_heads, group]`` (no materialized KV repeat), scores and
softmax are fp32, probabilities are cast to v's dtype before the value
product, which accumulates in fp32 (float64 throughout in a float64 run).
"""

from __future__ import annotations

import torch

from .nn import acc_dtype

NEG_INF = -1e9


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mask=None) -> torch.Tensor:
    """q [B, Hq, Tq, D]; k, v [B, Hkv, Tk, D]; mask additive, broadcastable
    to [B, 1, Tq, Tk] (or [B, Hq, Tq, Tk]). Returns [B, Hq, Tq, D]."""
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, tq, d)
    # bf16 × bf16 products are exact in fp32: upcasting the operands gives
    # the reference's bf16-in / fp32-accumulate scores
    ct = acc_dtype(q.dtype)
    scores = torch.matmul(qg.to(ct), k.to(ct)[:, :, None].transpose(-1, -2)) * scale
    if mask is not None:
        mb = mask.to(scores.dtype)
        if mb.dim() == 4:
            if mb.shape[1] == 1:
                mb = mb[:, :, None]
            else:
                mb = mb.reshape(b, hkv, group, tq, mb.shape[-1])
        scores = scores + mb
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.to(ct), v.to(ct)[:, :, None])
    return out.reshape(b, hq, tq, d).to(q.dtype)
