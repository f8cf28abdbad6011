"""Weights carried across: the JAX package's parameter tree → torch tensors.

A parameter tree here has the same nesting, names and layouts as the JAX
package's (dense kernels ``[in, out]``, conv kernels HWIO, packed MLX
linears ``{"codes", "scales", "biases"}``), with torch tensors as leaves,
so a tree converted from the reference and one drawn here are
interchangeable.

Leaf rules (mirroring ``qwen3_asr_swift_tpu/ops/quant.py::cast_tree``):

- float leaves are cast to the model dtype;
- packed ``codes`` (uint32 in the reference) are kept bit for bit as an
  int32 view, because torch has few uint32 ops — every consumer masks
  after shifting, so the sign bit never leaks into a code;
- group ``scales`` and ``biases`` stay fp32 (they are 1/group_size the
  size of the codes, so their accuracy is free);
- integer leaves are never cast.

The random initialisers draw with numpy from a seed and pack with the
port's copy of the reference's ``core.weights.quantize_mlx``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .weights import quantize_mlx


def _to_numpy(x) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else np.asarray(x)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of a JAX array
        arr = arr.copy()
    return torch.from_numpy(arr)


def _float_tensor(x, device, dtype) -> torch.Tensor:
    return _tensor(_to_numpy(x).astype(np.float32, copy=False)).to(device, dtype)


def params_from_jax(tree, device, dtype=torch.bfloat16):
    """Turn a parameter tree of numpy (or JAX) arrays into the port's
    tensors on ``device`` (see the module docstring for the leaf rules)."""

    def walk(node):
        if isinstance(node, dict):
            if "codes" in node:
                codes = np.ascontiguousarray(_to_numpy(node["codes"]).astype(np.uint32, copy=False))
                out = {
                    "codes": _tensor(codes.view(np.int32)).to(device),
                    "scales": _float_tensor(node["scales"], device, torch.float32),
                    "biases": _float_tensor(node["biases"], device, torch.float32),
                }
                if "bias" in node:
                    out["bias"] = _float_tensor(node["bias"], device, dtype)
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if isinstance(node, torch.Tensor):
            return node.to(device, dtype) if node.is_floating_point() else node.to(device)
        arr = _to_numpy(node)
        if np.issubdtype(arr.dtype, np.floating):
            return _float_tensor(arr, device, dtype)
        return _tensor(arr).to(device)

    return walk(tree)


def tree_tensors(tree):
    """Every tensor leaf of a tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


# ---------------------------------------------------------------------------
# random initialisation (numpy, from a seed) — mirrors the layouts of
# qwen3_asr_swift_tpu/models/qwen3_asr/{encoder,decoder}.py init_*_params
# ---------------------------------------------------------------------------

def _normal(rng: np.random.Generator, shape, scale) -> np.ndarray:
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _linear(rng, d_in: int, d_out: int, bias: bool = True) -> dict:
    p = {"kernel": _normal(rng, (d_in, d_out), 1.0 / np.sqrt(d_in))}
    if bias:
        p["bias"] = np.zeros((d_out,), np.float32)
    return p


def _norm(d: int, bias: bool) -> dict:
    p = {"weight": np.ones((d,), np.float32)}
    if bias:
        p["bias"] = np.zeros((d,), np.float32)
    return p


def init_encoder_params_np(rng: np.random.Generator, cfg) -> dict:
    ch = cfg.downsample_hidden

    def conv(c_in, c_out):
        return {"kernel": _normal(rng, (3, 3, c_in, c_out), 1.0 / np.sqrt(9 * c_in)),
                "bias": np.zeros((c_out,), np.float32)}

    d = cfg.d_model
    params = {
        "conv1": conv(1, ch),
        "conv2": conv(ch, ch),
        "conv3": conv(ch, ch),
        "conv_out": _linear(rng, cfg.conv_out_input_dim, d, bias=False),
        "ln_post": _norm(d, bias=True),
        "proj1": _linear(rng, d, d),
        "proj2": _linear(rng, d, cfg.output_dim),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "q_proj": _linear(rng, d, d),
            "k_proj": _linear(rng, d, d),
            "v_proj": _linear(rng, d, d),
            "out_proj": _linear(rng, d, d),
            "attn_ln": _norm(d, bias=True),
            "fc1": _linear(rng, d, cfg.ffn_dim),
            "fc2": _linear(rng, cfg.ffn_dim, d),
            "final_ln": _norm(d, bias=True),
        })
    return params


def init_decoder_params_np(rng: np.random.Generator, cfg) -> dict:
    h, hd = cfg.hidden_size, cfg.head_dim
    params = {
        "embed_tokens": _normal(rng, (cfg.vocab_size, h), 0.02),
        "norm": _norm(h, bias=False),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "q_proj": _linear(rng, h, cfg.num_heads * hd, bias=False),
            "k_proj": _linear(rng, h, cfg.num_kv_heads * hd, bias=False),
            "v_proj": _linear(rng, h, cfg.num_kv_heads * hd, bias=False),
            "o_proj": _linear(rng, cfg.num_heads * hd, h, bias=False),
            "q_norm": _norm(hd, bias=False),
            "k_norm": _norm(hd, bias=False),
            "input_layernorm": _norm(h, bias=False),
            "post_attention_layernorm": _norm(h, bias=False),
            "mlp": {
                "gate_proj": _linear(rng, h, cfg.intermediate_size, bias=False),
                "up_proj": _linear(rng, h, cfg.intermediate_size, bias=False),
                "down_proj": _linear(rng, cfg.intermediate_size, h, bias=False),
            },
        })
    return params


def quantize_tree_np(params, bits: int, group_size: int = 64,
                     embed_keys=("embed_tokens",), min_dim: int = 128):
    """numpy twin of ``qwen3_asr_swift_tpu/ops/quant.py::quantize_tree``:
    pack every eligible ``{"kernel": [in, out]}`` linear (in % group == 0,
    both dims >= ``min_dim``) and every table named in ``embed_keys`` into
    the MLX format. Other leaves pass through."""

    def pack(w_out_in):
        codes, scales, biases = quantize_mlx(np.asarray(w_out_in, np.float32), bits, group_size)
        return {"codes": codes, "scales": scales, "biases": biases}

    def walk(node, name=""):
        if isinstance(node, dict):
            k = node.get("kernel")
            if k is not None and getattr(k, "ndim", 0) == 2:
                d_in, d_out = k.shape
                if d_in % group_size == 0 and d_in >= min_dim and d_out >= min_dim:
                    q = pack(np.asarray(k).T)
                    if "bias" in node:
                        q["bias"] = node["bias"]
                    return q
                return node
            return {k2: walk(v, k2) for k2, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        if (name in embed_keys and getattr(node, "ndim", 0) == 2
                and node.shape[1] % group_size == 0 and node.shape[1] >= min_dim):
            return pack(node)
        return node

    return walk(params)


def init_random_params(cfg, seed: int = 0, quant_bits: Optional[int] = None):
    """(encoder tree, decoder tree) of numpy arrays drawn from ``seed``;
    ``quant_bits`` packs the decoder linears and embedding (group 64)."""
    rng = np.random.default_rng(seed)
    enc = init_encoder_params_np(rng, cfg.encoder)
    dec = init_decoder_params_np(rng, cfg.decoder)
    if quant_bits:
        dec = quantize_tree_np(dec, quant_bits)
    return enc, dec
