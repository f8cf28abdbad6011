"""Device decoders of the audio wire formats — port of the device half of
``qwen3_asr_swift_tpu/audio/companding.py``.

The host encoders (``mulaw_encode_np``, ``pcm4_encode_np``,
``dpcm4_encode_np``) are the reference's jax-free numpy functions, reused
as they are; only the payload crosses to the device, and these decode it
there.
"""

from __future__ import annotations

import torch

from qwen3_asr_swift_tpu.audio.companding import MU, PCM4_BLOCK

_QMAX = 127.0
_Q4MAX = 7.0


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
