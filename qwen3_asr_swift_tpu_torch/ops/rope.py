"""Rotary position embeddings (split-half) — port of ``qwen3_asr_swift_tpu/ops/rope.py``."""

from __future__ import annotations

import threading

import numpy as np
import torch

_inv_freq_lock = threading.Lock()
_inv_freq: dict = {}


def _inverse_frequencies(head_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """Cached per device: a host→device copy per call would make every
    decode layer wait for the device to drain."""
    key = (head_dim, base, str(device))
    with _inv_freq_lock:
        if key not in _inv_freq:
            half = head_dim // 2
            inv = 1.0 / (base ** (np.arange(0, half, dtype=np.float64) / half))
            _inv_freq[key] = torch.tensor(inv, dtype=torch.float32, device=device)
        return _inv_freq[key]


def rope_angles(positions: torch.Tensor, head_dim: int, base: float = 1e6):
    """positions int [...P] → (cos, sin), each fp32 [...P, head_dim/2]."""
    inv = _inverse_frequencies(head_dim, base, positions.device)
    angles = positions.to(torch.float32)[..., None] * inv
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """[x1, x2] → [x1*cos - x2*sin, x2*cos + x1*sin] over the last dim."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
