"""Decode attention over an int8 KV cache — port of
``qwen3_asr_swift_tpu/ops/attention_pallas.py``.

:func:`decode_attention_int8` is the wrapper of kernel K3
(``csrc/decode_attn_int8.cu``): for a CUDA tensor it launches the kernel
or raises; only for a CPU tensor does it take the plain
:func:`decode_attention_int8_ref`. Both compute the reference kernel's
function: single-token GQA attention with the per-slot scales folded into
the scores (``q·k_j·s_j``) and the probabilities (``(p·s_v)@V``), an exact
softmax over all of L, and masked rows at NEG_INF = -1e30, in fp32. q may
be bf16 (widened exactly) or fp32; ``out_dtype`` bf16 rounds the fp32
result once, as ``.to(torch.bfloat16)`` does.

The kernel splits L over blocks (:func:`split_keys`), each block's keys
streamed through a two-tile ring in shared memory; the splits' partial
softmaxes go to a workspace and merge in split order, in a second kernel
of the same launch.
"""

from __future__ import annotations

import math

import torch

from . import cuda_build

NEG_INF = -1e30

#: launches of kernel K3
K3_LAUNCHES = cuda_build.LaunchCounter("decode_attention_int8")

#: K and V bytes a block of K3 reads at most: a split takes the fewest
#: blocks of this size that cover L, with its keys evened out over them
SPLIT_BYTES = 49152

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def split_keys(length: int, d: int) -> int:
    """Keys per block of K3 at cache length ``length`` and head dim ``d``
    (the last split may be shorter). It depends on L and D only, never on
    B, so a row's result does not depend on the rows beside it; one split
    (``length`` itself) means no merge."""
    per = max(1, SPLIT_BYTES // (2 * d))
    n_split = -(-length // per)
    return -(-length // n_split)


def decode_attention_int8_ref(q, k_codes, k_scale, v_codes, v_scale, valid) -> torch.Tensor:
    """Plain version. q [B, Hq, 1, D]; k/v codes [B, Hkv, L, D] int8;
    scales [B, Hkv, L] fp32; valid [B, L] bool → fp32 [B, Hq, 1, D]."""
    b, hq, _, d = q.shape
    hkv = k_codes.shape[1]
    group = hq // hkv
    qg = q[:, :, 0].float().reshape(b, hkv, group, d)
    scores = torch.matmul(qg, k_codes.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    scores = scores * k_scale[:, :, None, :]
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))          # [B, Hkv, G, L]
    num = torch.matmul(p * v_scale[:, :, None, :], v_codes.float())      # [B, Hkv, G, D]
    out = num / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, hq, 1, d)


def _check(q, k_codes, k_scale, v_codes, v_scale, valid):
    b, hq, one, d = q.shape
    if one != 1:
        raise ValueError(f"q must be [B, Hq, 1, D], got {tuple(q.shape)}")
    if k_codes.dim() != 4 or k_codes.shape != v_codes.shape:
        raise ValueError(f"k/v codes shapes {tuple(k_codes.shape)} {tuple(v_codes.shape)}")
    kb, hkv, l, kd = k_codes.shape
    if kb != b or kd != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_codes.shape)}")
    group = hq // hkv
    if group not in (1, 2, 4, 8) or d not in (32, 64, 128, 256) or group * d > 1024:
        raise ValueError(f"kernel takes group 1/2/4/8, D 32/64/128/256 and group*D <= 1024 "
                         f"(group {group}, D {d})")
    if k_scale.shape != (b, hkv, l) or v_scale.shape != (b, hkv, l):
        raise ValueError("scales must be [B, Hkv, L]")
    if valid.shape != (b, l) or valid.dtype != torch.bool:
        raise ValueError("valid must be bool [B, L]")
    for name, t, dt in (("k_codes", k_codes, torch.int8), ("v_codes", v_codes, torch.int8),
                        ("k_scale", k_scale, torch.float32), ("v_scale", v_scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("k_codes", k_codes), ("v_codes", v_codes), ("k_scale", k_scale),
                    ("v_scale", v_scale), ("valid", valid)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (k_codes.data_ptr() | v_codes.data_ptr()) % 16:
        raise ValueError("k/v codes must be 16-byte aligned")


def decode_attention_int8(q, k_codes, k_scale, v_codes, v_scale, valid,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Kernel K3 (see module docstring); returns [B, Hq, 1, D] in
    ``out_dtype`` (fp32, the reference function, or bf16)."""
    if q.device.type == "cpu":
        return decode_attention_int8_ref(q, k_codes, k_scale, v_codes, v_scale,
                                         valid).to(out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: unsupported device {q.device}")
    _check(q, k_codes, k_scale, v_codes, v_scale, valid)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or fp32, got {q.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be fp32 or bf16, got {out_dtype}")
    b, hq, _, d = q.shape
    hkv, l = k_codes.shape[1], k_codes.shape[2]
    group = hq // hkv
    q = q.contiguous()   # [B, Hq, 1, D] ≡ [B, Hkv, G, D]; a view for the decoder's q
    split = split_keys(l, d)
    n_split = -(-l // split)
    out = torch.empty((b, hq, 1, d), dtype=out_dtype, device=q.device)
    ws = (torch.empty(b * hkv * n_split * group * (d + 2), dtype=torch.float32, device=q.device)
          if n_split > 1 else None)
    lib = cuda_build.library()
    err = lib.qs_decode_attn_int8(
        q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
        v_scale.data_ptr(), valid.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, hkv, group, l, d, split,
        int(q.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        1.0 / math.sqrt(d), cuda_build.stream_handle(q.device))
    cuda_build.check(err, "qs_decode_attn_int8")
    K3_LAUNCHES.add()
    return out
