"""Checkpoint reading and MLX group quantization — the port's copies from
``qwen3_asr_swift_tpu/core/weights.py``.

``load_safetensors`` reads every shard of a directory into a flat
``{name: np.ndarray}`` dict, as the reference's does, but without
``ml_dtypes``: numpy has no bfloat16, so a bf16 tensor is read through
safetensors' torch reader and handed back as float32 (bf16 is a subset of
fp32, so the values are the same). ``dequantize_mlx`` and ``quantize_mlx``
are copies.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def load_safetensors(model_dir: str | Path, dtype: Optional[np.dtype] = None) -> Dict[str, np.ndarray]:
    """Load all safetensors shards in a directory into a flat dict.

    Respects ``model.safetensors.index.json`` when present; otherwise loads
    every ``*.safetensors`` file. bf16 tensors come back as float32."""
    from safetensors import safe_open

    model_dir = Path(model_dir)
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        shards = sorted({model_dir / fname for fname in weight_map.values()})
    else:
        shards = sorted(model_dir.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")

    out: Dict[str, np.ndarray] = {}
    for shard in shards:
        with safe_open(str(shard), framework="np") as f:
            bf16 = {name for name in f.keys() if f.get_slice(name).get_dtype() == "BF16"}
            for name in f.keys():
                if name not in bf16:
                    out[name] = f.get_tensor(name)
        if bf16:
            with safe_open(str(shard), framework="pt") as f:
                for name in bf16:
                    out[name] = f.get_tensor(name).float().numpy()
    if dtype is not None:
        out = {name: arr.astype(dtype) if np.issubdtype(arr.dtype, np.floating) else arr
               for name, arr in out.items()}
    return out


def dequantize_mlx(
    weight: np.ndarray,
    scales: np.ndarray,
    biases: np.ndarray,
    bits: int,
    group_size: int = 64,
    dtype=np.float32,
) -> np.ndarray:
    """Dequantize an MLX group-quantized matrix.

    MLX packs unsigned ``bits``-wide codes along the last (input) axis into
    uint32 words, least-significant bits first: code ``j`` within a word is
    ``(word >> (bits*j)) & mask``. Each group of ``group_size`` inputs shares
    an fp16 ``scale`` and ``bias``: ``w = scale * code + bias``.

    Args:
        weight: uint32 [out, in * bits / 32]
        scales: [out, in / group_size]
        biases: [out, in / group_size]
    Returns:
        float [out, in]
    """
    if bits not in (2, 4, 8):
        raise ValueError(f"unsupported bit width: {bits}")
    per_word = 32 // bits
    mask = (1 << bits) - 1
    w = weight.astype(np.uint32)
    out_dim, packed_in = w.shape
    in_dim = packed_in * per_word

    shifts = (np.arange(per_word, dtype=np.uint32) * bits)[None, None, :]
    codes = (w[:, :, None] >> shifts) & mask  # [out, packed_in, per_word]
    codes = codes.reshape(out_dim, in_dim).astype(dtype)

    s = scales.astype(dtype).repeat(group_size, axis=1)[:, :in_dim]
    b = biases.astype(dtype).repeat(group_size, axis=1)[:, :in_dim]
    return codes * s + b



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
