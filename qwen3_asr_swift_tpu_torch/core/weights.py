"""The port's copy of ``quantize_mlx`` from ``qwen3_asr_swift_tpu/core/weights.py``:
MLX group quantization of a dense matrix.
"""

from __future__ import annotations

import numpy as np


def quantize_mlx(w: np.ndarray, bits: int, group_size: int = 64):
    """Inverse of the reference's ``dequantize_mlx`` (for tests and on-the-fly
    quantization of fp checkpoints). Returns (packed_u32, scales, biases)."""
    out_dim, in_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"in_dim {in_dim} not divisible by group size {group_size}")
    per_word = 32 // bits
    levels = (1 << bits) - 1

    grouped = w.reshape(out_dim, in_dim // group_size, group_size)
    gmax = grouped.max(axis=-1)
    gmin = grouped.min(axis=-1)
    scales = ((gmax - gmin) / levels).astype(np.float32)
    scales = np.where(scales == 0, 1e-8, scales)
    biases = gmin.astype(np.float32)

    codes = np.clip(np.round((grouped - biases[..., None]) / scales[..., None]), 0, levels)
    codes = codes.reshape(out_dim, in_dim).astype(np.uint32)

    packed = np.zeros((out_dim, in_dim // per_word), dtype=np.uint32)
    for j in range(per_word):
        packed |= codes[:, j::per_word] << np.uint32(j * bits)
    return packed, scales, biases
