"""Rotary position embeddings (split-half) — port of ``qwen3_asr_swift_tpu/ops/rope.py``."""

from __future__ import annotations

import threading

import numpy as np
import torch

from .nn import upcast

_inv_freq_lock = threading.Lock()
_inv_freq: dict = {}


def _inverse_frequencies(head_dim: int, base: float, device: torch.device,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Cached per device: a host→device copy per call would make every
    decode layer wait for the device to drain."""
    key = (head_dim, base, str(device), dtype)
    with _inv_freq_lock:
        if key not in _inv_freq:
            half = head_dim // 2
            inv = 1.0 / (base ** (np.arange(0, half, dtype=np.float64) / half))
            _inv_freq[key] = torch.tensor(inv, dtype=dtype, device=device)
        return _inv_freq[key]


def rope_angles(positions: torch.Tensor, head_dim: int, base: float = 1e6,
                dtype: torch.dtype = torch.float32):
    """positions int [...P] → (cos, sin), each [...P, head_dim/2] in
    ``dtype`` (fp32; float64 for a float64 run)."""
    inv = _inverse_frequencies(head_dim, base, positions.device, dtype)
    angles = positions.to(dtype)[..., None] * inv
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """[x1, x2] → [x1*cos - x2*sin, x2*cos + x1*sin] over the last dim."""
    half = x.shape[-1] // 2
    x1 = upcast(x[..., :half])
    x2 = upcast(x[..., half:])
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope_reference(x: np.ndarray, positions: np.ndarray, base: float = 1e6) -> np.ndarray:
    """Pure-numpy split-half RoPE for parity tests."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    inv_freq = 1.0 / (base ** (np.arange(0, half, dtype=np.float64) / half))
    ang = positions[..., None].astype(np.float64) * inv_freq
    cos, sin = np.cos(ang), np.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1).astype(x.dtype)
