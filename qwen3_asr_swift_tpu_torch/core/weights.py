"""Checkpoint reading and MLX group quantization — the port's copies from
``qwen3_asr_swift_tpu/core/weights.py``.

``load_safetensors`` reads every shard of a directory into a flat
``{name: np.ndarray}`` dict, as the reference's does, but without
``ml_dtypes``: numpy has no bfloat16, so a bf16 tensor is read through
safetensors' torch reader and handed back as float32 (bf16 is a subset of
fp32, so the values are the same). ``dequantize_mlx`` and ``quantize_mlx``
are copies, and so are ``maybe_dequantize_linear``, ``unflatten``,
``relist``, ``flatten`` and ``fuse_weight_norm`` (the CosyVoice converter's
weight-norm fusion). ``param_bytes`` sums the bytes of a tree's tensors and
arrays.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def read_safetensors_file(path: str | Path) -> Dict[str, np.ndarray]:
    """Every tensor of one ``.safetensors`` file; bf16 comes back as float32."""
    from safetensors import safe_open

    out: Dict[str, np.ndarray] = {}
    with safe_open(str(path), framework="np") as f:
        bf16 = {name for name in f.keys() if f.get_slice(name).get_dtype() == "BF16"}
        for name in f.keys():
            if name not in bf16:
                out[name] = f.get_tensor(name)
    if bf16:
        with safe_open(str(path), framework="pt") as f:
            for name in bf16:
                out[name] = f.get_tensor(name).float().numpy()
    return out


def load_safetensors(model_dir: str | Path, dtype: Optional[np.dtype] = None) -> Dict[str, np.ndarray]:
    """Load all safetensors shards in a directory into a flat dict.

    Respects ``model.safetensors.index.json`` when present; otherwise loads
    every ``*.safetensors`` file. bf16 tensors come back as float32."""
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
        out.update(read_safetensors_file(shard))
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


def unflatten(flat: Dict[str, np.ndarray], sep: str = ".") -> dict:
    """Turn {'a.b.c': x} into {'a': {'b': {'c': x}}}."""
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        parts = name.split(sep)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def relist(tree):
    """Recursively turn dicts whose keys are all digit strings ("0","1",…)
    back into lists — the inverse of flattening a tree that contains
    lists of layer params."""
    if isinstance(tree, dict):
        if tree and all(isinstance(k, str) and k.isdigit() for k in tree):
            # only a dense 0..n-1 index set is a flattened list; a gapped or
            # offset set (e.g. "0","1","3") stays a dict rather than KeyError
            indices = sorted(int(k) for k in tree)
            if indices == list(range(len(tree))):
                return [relist(tree[str(i)]) for i in indices]
        return {k: relist(v) for k, v in tree.items()}
    return tree


def fuse_weight_norm(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Collapse torch weight-norm parameter pairs into plain ``X.weight``.

    Handles both the legacy ``weight_g``/``weight_v`` naming and the
    parametrize-era ``parametrizations.weight.original0/1`` naming, for
    ``dim=0`` weight norm (torch's default for conv/linear). Shared by the
    CosyVoice, Kokoro, and VoxCPM2 converters; pinned against torch's own
    materialized weights in tests/test_cosyvoice_vibevoice.py."""
    out = dict(flat)
    for key in list(flat):
        base = None
        if key.endswith(".weight_v"):
            base = key[: -len(".weight_v")]
            g, v = flat.get(base + ".weight_g"), flat[key]
        elif key.endswith(".parametrizations.weight.original1"):
            base = key[: -len(".parametrizations.weight.original1")]
            g = flat.get(base + ".parametrizations.weight.original0")
            v = flat[key]
        if base is None or g is None:
            continue
        norm = np.sqrt(np.sum(np.square(v.astype(np.float64)),
                              axis=tuple(range(1, v.ndim)), keepdims=True))
        g = g.astype(np.float64).reshape(norm.shape)
        out[base + ".weight"] = (g * v.astype(np.float64)
                                 / np.maximum(norm, 1e-12)).astype(np.float32)
        for suffix in (".weight_g", ".weight_v", ".parametrizations.weight.original0",
                       ".parametrizations.weight.original1"):
            out.pop(base + suffix, None)
    return out


def flatten(tree: dict, prefix: str = "", sep: str = ".") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        name = f"{prefix}{sep}{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flatten(value, name, sep))
        else:
            out[name] = value
    return out


def maybe_dequantize_linear(params: Dict[str, np.ndarray], prefix: str, bits: int, group_size: int = 64,
                            dtype=np.float32) -> Optional[np.ndarray]:
    """If ``{prefix}.weight`` is MLX-quantized (scales present), return the
    dequantized fp matrix; if plain fp weight, return it; else None."""
    w = params.get(f"{prefix}.weight")
    if w is None:
        return None
    scales = params.get(f"{prefix}.scales")
    if scales is None:
        return w.astype(dtype) if np.issubdtype(w.dtype, np.floating) else w
    biases = params.get(f"{prefix}.biases")
    if biases is None:
        # symmetric/scale-only quant exports ship no biases: zeros
        biases = np.zeros_like(np.asarray(scales))
    return dequantize_mlx(w, scales, biases, bits=bits, group_size=group_size, dtype=dtype)


def param_bytes(tree) -> int:
    """Total bytes of all leaves (for ModelMemoryStats): every tensor or
    array in a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return tree.nbytes if hasattr(tree, "nbytes") else 0
