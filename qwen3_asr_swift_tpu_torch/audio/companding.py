"""The audio wire formats — port of ``qwen3_asr_swift_tpu/audio/companding.py``.

The host encoders (``mulaw_encode_np``, ``pcm4_encode_np``,
``dpcm4_encode_np``) are copies of the reference's numpy encoders (its
native C++ fast path is not ported: numpy at every size); only the payload
crosses to the device, and the decoders below decode it there.
"""

from __future__ import annotations

import numpy as np
import torch

MU = 255.0
#: int8 quantization range — symmetric so decode is sign-exact
_QMAX = 127.0
#: pcm4/dpcm4 samples per block (one scale each)
PCM4_BLOCK = 128
_Q4MAX = 7.0


def mulaw_encode_np(x: np.ndarray, mu: float = MU) -> np.ndarray:
    """float32 PCM in [-1, 1] → µ-law int8 in [-127, 127] (host side)."""
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return np.round(y * _QMAX).astype(np.int8)


def pcm4_encode_np(x: np.ndarray):
    """float32 PCM [..., N] (N a multiple of 2*PCM4_BLOCK) → (packed
    uint8 [..., N//2], scales float16 [..., N//PCM4_BLOCK])."""
    n = x.shape[-1]
    if n % (2 * PCM4_BLOCK):
        raise ValueError(f"pcm4 length {n} not a multiple of {2 * PCM4_BLOCK}")
    blocks = x.reshape(*x.shape[:-1], n // PCM4_BLOCK, PCM4_BLOCK)
    scale = np.maximum(np.abs(blocks).max(axis=-1), 1e-5).astype(np.float16)
    # quantize against the float16-rounded scale the decoder will see, so
    # |q| <= 7 exactly and the roundtrip is centered
    y = blocks / scale[..., None].astype(np.float32)
    q = np.clip(np.round(y * _Q4MAX), -7, 7).astype(np.int8).reshape(*x.shape[:-1], n)
    packed = (q[..., 0::2] & 0xF) | ((q[..., 1::2] & 0xF) << 4)
    return packed.astype(np.uint8), scale


def dpcm4_encode_np(x: np.ndarray):
    """float32 PCM [..., N] (N a multiple of 2*PCM4_BLOCK) → (packed
    uint8 [..., N//2], scales2 float16 [..., 2*N//PCM4_BLOCK]).

    scales2 interleaves (delta_scale, first_sample) per block. The
    encoder quantizes each delta against the RECONSTRUCTED previous
    sample (closed loop), so quantization error never accumulates
    through the block's cumsum — the open-loop variant loses ~12 dB to
    exactly that accumulation."""
    n = x.shape[-1]
    if n % (2 * PCM4_BLOCK):
        raise ValueError(f"dpcm4 length {n} not a multiple of {2 * PCM4_BLOCK}")
    lead = x.shape[:-1]
    nb = n // PCM4_BLOCK
    blocks = x.reshape(*lead, nb, PCM4_BLOCK).astype(np.float32)
    d = np.diff(blocks, axis=-1)
    scale = np.maximum(np.abs(d).max(axis=-1) / _Q4MAX, 1e-6).astype(np.float16)
    x0 = blocks[..., 0].astype(np.float16)
    s = scale.astype(np.float32)
    r = x0.astype(np.float32)
    q = np.zeros(blocks.shape, np.int8)
    for i in range(1, PCM4_BLOCK):
        e = blocks[..., i] - r
        qi = np.clip(np.round(e / s), -7, 7)
        r = r + qi * s
        q[..., i] = qi
    qf = q.reshape(*lead, n)
    packed = (qf[..., 0::2] & 0xF) | ((qf[..., 1::2] & 0xF) << 4)
    scales2 = np.stack([scale, x0], axis=-1).reshape(*lead, 2 * nb)
    return packed.astype(np.uint8), scales2


def mulaw_decode(y: torch.Tensor, mu: float = MU) -> torch.Tensor:
    """µ-law int8 → fp32 PCM."""
    yf = y.float() / _QMAX
    return torch.sign(yf) * (torch.pow(1.0 + mu, yf.abs()) - 1.0) / mu


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., N//2] → signed int32 nibbles [..., N] (low nibble first)."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def pcm4_decode(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(uint8 [..., N//2], float16 [..., N//128]) → fp32 PCM [..., N]."""
    x = _unpack_nibbles(packed).float() / _Q4MAX
    x = x.reshape(*x.shape[:-1], scales.shape[-1], PCM4_BLOCK)
    x = x * scales.float()[..., None]
    return x.reshape(*packed.shape[:-1], -1)


def dpcm4_decode(packed: torch.Tensor, scales2: torch.Tensor) -> torch.Tensor:
    """(uint8 [..., N//2], float16 [..., 2*N//128] of (delta scale, first
    sample) pairs) → fp32 PCM: one parallel cumsum per block."""
    q = _unpack_nibbles(packed)
    nb = scales2.shape[-1] // 2
    pairs = scales2.reshape(*scales2.shape[:-1], nb, 2).float()
    scale, x0 = pairs[..., 0], pairs[..., 1]
    inc = q.reshape(*q.shape[:-1], nb, PCM4_BLOCK).float() * scale[..., None]
    inc[..., 0] = 0.0
    x = x0[..., None] + torch.cumsum(inc, dim=-1)
    return x.reshape(*packed.shape[:-1], -1)
