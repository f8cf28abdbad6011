"""Checkpoint → param-tree conversion for Qwen3-ASR — a copy of
``qwen3_asr_swift_tpu/models/qwen3_asr/convert.py`` (numpy only).

Maps the published checkpoint names (HF `audio_tower.*` / `model.*`, or the
aligner's `thinker.*` prefix — reference:
Sources/Qwen3ASR/WeightLoading.swift:42-209) into this package's canonical
param trees, handling:
- Linear [out, in] → [in, out] (kernels are stored input-major here),
- Conv2d layout: torch OIHW or MLX OHWI → JAX HWIO (detected by shape),
- MLX group-quantized tensors (weight/scales/biases triplets) → dequantized
  fp (or kept packed for the quantized-matmul path).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ...core.weights import dequantize_mlx
from .config import Qwen3ASRConfig


def _conv_to_hwio(w: np.ndarray) -> np.ndarray:
    if w.ndim != 4:
        raise ValueError(f"conv weight must be 4D, got {w.shape}")
    if w.shape[1] == 3 and w.shape[2] == 3:  # MLX OHWI
        return np.transpose(w, (1, 2, 3, 0))
    return np.transpose(w, (2, 3, 1, 0))  # torch OIHW


def _linear(flat: Dict[str, np.ndarray], prefix: str, bits: int, group: int, dtype,
            keep_quantized: bool = False) -> dict:
    """Build a linear param dict from fp or MLX-quantized weights: either
    {"kernel" [in,out], "bias"?} dense, or — when the checkpoint is
    quantized and ``keep_quantized`` — the packed {"codes","scales",
    "biases"} dict consumed by ops.quant (no dense materialization)."""
    w = flat.get(f"{prefix}.weight")
    if w is None:
        raise KeyError(f"missing {prefix}.weight")
    if f"{prefix}.scales" in flat:
        if keep_quantized:
            p = {"codes": flat[f"{prefix}.weight"].astype(np.uint32),
                 "scales": flat[f"{prefix}.scales"].astype(np.float32),
                 "biases": flat[f"{prefix}.biases"].astype(np.float32)}
            if f"{prefix}.bias" in flat:
                p["bias"] = flat[f"{prefix}.bias"].astype(dtype)
            return p
        w = dequantize_mlx(w, flat[f"{prefix}.scales"], flat[f"{prefix}.biases"],
                           bits=bits, group_size=group)
    p = {"kernel": np.ascontiguousarray(w.T).astype(dtype)}
    if f"{prefix}.bias" in flat:
        p["bias"] = flat[f"{prefix}.bias"].astype(dtype)
    return p


def _ln(flat, prefix, dtype) -> dict:
    return {
        "weight": flat[f"{prefix}.weight"].astype(dtype),
        "bias": flat[f"{prefix}.bias"].astype(dtype),
    }


def _rms(flat, prefix, dtype) -> dict:
    return {"weight": flat[f"{prefix}.weight"].astype(dtype)}


def strip_prefixes(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip the aligner's `thinker.` prefix when present."""
    out = {}
    for k, v in flat.items():
        out[k[len("thinker."):] if k.startswith("thinker.") else k] = v
    return out


def convert_encoder(flat: Dict[str, np.ndarray], cfg: Qwen3ASRConfig, dtype=np.float32,
                    keep_quantized: bool = True) -> dict:
    f = {k[len("audio_tower."):]: v for k, v in strip_prefixes(flat).items()
         if k.startswith("audio_tower.") or k.startswith("thinker.audio_tower.")}
    bits, group = cfg.decoder.bits, cfg.decoder.group_size
    lin = lambda pre: _linear(f, pre, bits, group, dtype, keep_quantized)
    params = {
        "conv1": {"kernel": _conv_to_hwio(f["conv2d1.weight"]).astype(dtype)},
        "conv2": {"kernel": _conv_to_hwio(f["conv2d2.weight"]).astype(dtype)},
        "conv3": {"kernel": _conv_to_hwio(f["conv2d3.weight"]).astype(dtype)},
        "conv_out": lin("conv_out"),
        "ln_post": _ln(f, "ln_post", dtype),
        "proj1": lin("proj1"),
        "proj2": lin("proj2"),
        "layers": [],
    }
    for name, tgt in (("conv2d1", "conv1"), ("conv2d2", "conv2"), ("conv2d3", "conv3")):
        if f"{name}.bias" in f:
            params[tgt]["bias"] = f[f"{name}.bias"].astype(dtype)
    for i in range(cfg.encoder.num_layers):
        pre = f"layers.{i}"
        params["layers"].append(
            {
                "q_proj": lin(f"{pre}.self_attn.q_proj"),
                "k_proj": lin(f"{pre}.self_attn.k_proj"),
                "v_proj": lin(f"{pre}.self_attn.v_proj"),
                "out_proj": lin(f"{pre}.self_attn.out_proj"),
                "attn_ln": _ln(f, f"{pre}.self_attn_layer_norm", dtype),
                "fc1": lin(f"{pre}.fc1"),
                "fc2": lin(f"{pre}.fc2"),
                "final_ln": _ln(f, f"{pre}.final_layer_norm", dtype),
            }
        )
    return params


def convert_decoder(flat: Dict[str, np.ndarray], cfg: Qwen3ASRConfig, dtype=np.float32,
                    keep_quantized: bool = True) -> dict:
    f = {k[len("model."):]: v for k, v in strip_prefixes(flat).items() if k.startswith("model.")}
    bits, group = cfg.decoder.bits, cfg.decoder.group_size
    lin = lambda pre: _linear(f, pre, bits, group, dtype, keep_quantized)

    if "embed_tokens.scales" in f:
        if keep_quantized:
            emb = {"codes": f["embed_tokens.weight"].astype(np.uint32),
                   "scales": f["embed_tokens.scales"].astype(np.float32),
                   "biases": f["embed_tokens.biases"].astype(np.float32)}
        else:
            emb = dequantize_mlx(f["embed_tokens.weight"], f["embed_tokens.scales"],
                                 f["embed_tokens.biases"], bits=bits,
                                 group_size=group).astype(dtype)
    else:
        emb = f["embed_tokens.weight"].astype(dtype)
    params = {
        "embed_tokens": emb,
        "norm": _rms(f, "norm", dtype),
        "layers": [],
    }
    for i in range(cfg.decoder.num_layers):
        pre = f"layers.{i}"
        params["layers"].append(
            {
                "q_proj": lin(f"{pre}.self_attn.q_proj"),
                "k_proj": lin(f"{pre}.self_attn.k_proj"),
                "v_proj": lin(f"{pre}.self_attn.v_proj"),
                "o_proj": lin(f"{pre}.self_attn.o_proj"),
                "q_norm": _rms(f, f"{pre}.self_attn.q_norm", dtype),
                "k_norm": _rms(f, f"{pre}.self_attn.k_norm", dtype),
                "input_layernorm": _rms(f, f"{pre}.input_layernorm", dtype),
                "post_attention_layernorm": _rms(f, f"{pre}.post_attention_layernorm", dtype),
                "mlp": {
                    "gate_proj": lin(f"{pre}.mlp.gate_proj"),
                    "up_proj": lin(f"{pre}.mlp.up_proj"),
                    "down_proj": lin(f"{pre}.mlp.down_proj"),
                },
            }
        )
    return params
