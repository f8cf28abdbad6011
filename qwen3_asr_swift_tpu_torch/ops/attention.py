"""Scaled dot-product attention with GQA — port of ``qwen3_asr_swift_tpu/ops/attention.py``.

Plain tensor math, as the reference's ``sdpa`` is plain XLA: query heads
reshape to ``[kv_heads, group]`` (no materialized KV repeat), scores and
softmax are fp32, probabilities are cast to v's dtype before the value
product, which accumulates in fp32 (float64 throughout in a float64 run).
The additive masks are fp32 on the device they are asked for (the card
unless the caller names another); ``sdpa_reference`` is the reference's
float64 numpy attention.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
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


def causal_mask(q_len: int, kv_len: int, q_offset=0, device="cuda") -> torch.Tensor:
    """Additive causal mask fp32 [1, 1, q_len, kv_len]: query i (at absolute
    position q_offset+i) attends to keys 0..q_offset+i
    (reference: QuantizedTextDecoder.swift:228-236)."""
    dev = resolve_device(device)
    if isinstance(q_offset, torch.Tensor):
        q_offset = q_offset.to(dev)
    rows = torch.arange(q_len, device=dev)[:, None] + q_offset
    cols = torch.arange(kv_len, device=dev)[None, :]
    mask = torch.zeros((q_len, kv_len), dtype=torch.float32, device=dev)
    return mask.masked_fill(cols > rows, NEG_INF)[None, None]


def length_mask(kv_len: int, valid_len, device="cuda") -> torch.Tensor:
    """Additive key-validity mask fp32 [1, 1, 1, kv_len] masking keys >= valid_len."""
    dev = resolve_device(device)
    if isinstance(valid_len, torch.Tensor):
        valid_len = valid_len.to(dev)
    cols = torch.arange(kv_len, device=dev)
    mask = torch.zeros(kv_len, dtype=torch.float32, device=dev)
    return mask.masked_fill(cols >= valid_len, NEG_INF)[None, None, None]


def decode_step_mask(kv_len: int, cache_len, device="cuda") -> torch.Tensor:
    """Mask for single-token decode against a preallocated KV cache:
    positions >= cache_len (unwritten slots) are invisible."""
    return length_mask(kv_len, cache_len, device)


def sdpa_reference(q, k, v, scale, mask=None):
    """Pure-numpy MHA/GQA attention for parity tests."""
    import numpy as np

    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    q64 = q.astype(np.float64) * scale
    out = np.empty_like(q, dtype=np.float64)
    for bi in range(b):
        for h in range(hq):
            kvh = h // group
            s = q64[bi, h] @ k[bi, kvh].astype(np.float64).T
            if mask is not None:
                m = mask
                mb = m[bi if m.shape[0] > 1 else 0]
                mh = mb[h if mb.shape[0] == hq else 0]
                s = s + mh.astype(np.float64)
            s = s - s.max(axis=-1, keepdims=True)
            p = np.exp(s)
            p /= p.sum(axis=-1, keepdims=True)
            out[bi, h] = p @ v[bi, kvh].astype(np.float64)
    return out.astype(q.dtype)
