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
- the group-dot layout keeps ``gcodes`` int8 and ``gscales``/``gbiases``
  fp32;
- integer leaves are never cast.

The random initialisers draw with numpy from a seed and pack with the
port's copy of the reference's ``core.weights.quantize_mlx``; given a
``torch.Generator`` in place of the numpy one, they draw their kernels and
tables on the generator's device (the quick way at full size), and
:func:`init_random_params` packs there with ``ops.quant.quantize_tree``,
the same function on tensors.
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
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return _tensor(_to_numpy(x).astype(np.float32, copy=False)).to(device, dtype)


def params_from_jax(tree, device, dtype=torch.bfloat16):
    """Turn a parameter tree of numpy (or JAX) arrays into the port's
    tensors on ``device`` (see the module docstring for the leaf rules)."""

    def walk(node):
        if isinstance(node, dict):
            if "gcodes" in node:
                out = {"gcodes": _tensor(_to_numpy(node["gcodes"]).astype(np.int8)).to(device),
                       "gscales": _float_tensor(node["gscales"], device, torch.float32),
                       "gbiases": _float_tensor(node["gbiases"], device, torch.float32)}
                if "bias" in node:
                    out["bias"] = _float_tensor(node["bias"], device, dtype)
                return out
            if "codes" in node:
                codes = node["codes"]
                if isinstance(codes, torch.Tensor):   # the port's own packing: int32 words
                    codes = codes.to(device)
                else:
                    codes = np.ascontiguousarray(_to_numpy(codes).astype(np.uint32, copy=False))
                    codes = _tensor(codes.view(np.int32)).to(device)
                out = {
                    "codes": codes,
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


# ---------------------------------------------------------------------------
# random initialisation (numpy, from a seed) — mirrors the layouts of
# qwen3_asr_swift_tpu/models/qwen3_asr/{encoder,decoder}.py init_*_params
# ---------------------------------------------------------------------------

def _normal(rng, shape, scale):
    """A standard normal draw times ``scale``: fp32 numpy from a numpy
    generator, or an fp32 tensor on a ``torch.Generator``'s device."""
    if isinstance(rng, torch.Generator):
        return torch.randn(shape, generator=rng, device=rng.device) * scale
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


def init_random_params(cfg, seed: int = 0, quant_bits: Optional[int] = None, device=None):
    """(encoder tree, decoder tree) drawn from ``seed``: numpy arrays, or
    with ``device`` tensors drawn there from a seeded ``torch.Generator``
    (other values than numpy's draw); ``quant_bits`` packs the decoder
    linears and embedding (group 64) on the host or on ``device``."""
    if device is None:
        rng = np.random.default_rng(seed)
    else:
        rng = torch.Generator(device=device).manual_seed(seed)
    enc = init_encoder_params_np(rng, cfg.encoder)
    dec = init_decoder_params_np(rng, cfg.decoder)
    if quant_bits:
        if device is None:
            dec = quantize_tree_np(dec, quant_bits)
        else:
            from ..ops.quant import quantize_tree

            dec = quantize_tree(dec, quant_bits)
    return enc, dec


# ---------------------------------------------------------------------------
# checkpoints in the published layout (tests and chip_smoke.py write their
# own: no published weights are fetched)
# ---------------------------------------------------------------------------

def round_floats(tree):
    """The tree with every float leaf rounded through bfloat16 and back to
    float32 numpy (what a checkpoint stored in bf16 holds)."""
    if isinstance(tree, dict):
        return {k: round_floats(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [round_floats(v) for v in tree]
    arr = _to_numpy(tree)
    if np.issubdtype(arr.dtype, np.floating):
        return _tensor(arr.astype(np.float32)).bfloat16().float().numpy()
    return arr


def _export_linear(p, name: str, out: dict) -> None:
    if "codes" in p:
        out[f"{name}.weight"] = _to_numpy(p["codes"]).astype(np.uint32)
        out[f"{name}.scales"] = _to_numpy(p["scales"])
        out[f"{name}.biases"] = _to_numpy(p["biases"])
    else:
        out[f"{name}.weight"] = np.ascontiguousarray(_to_numpy(p["kernel"]).T)
    if "bias" in p:
        out[f"{name}.bias"] = _to_numpy(p["bias"])


def checkpoint_flat(enc, dec) -> dict:
    """Flat ``{name: array}`` of an encoder and a decoder tree in the
    published Qwen3-ASR names and layouts (``audio_tower.*`` with torch OIHW
    convs, ``model.*``, linears ``[out, in]``, packed linears and tables as
    MLX ``weight``/``scales``/``biases`` triplets): the inverse of
    ``models/qwen3_asr/convert.py``."""
    out: dict = {}
    a = "audio_tower"
    for src, dst in (("conv1", "conv2d1"), ("conv2", "conv2d2"), ("conv3", "conv2d3")):
        out[f"{a}.{dst}.weight"] = np.ascontiguousarray(
            _to_numpy(enc[src]["kernel"]).transpose(3, 2, 0, 1))    # HWIO → OIHW
        if "bias" in enc[src]:
            out[f"{a}.{dst}.bias"] = _to_numpy(enc[src]["bias"])
    for name in ("conv_out", "proj1", "proj2"):
        _export_linear(enc[name], f"{a}.{name}", out)
    for k in ("weight", "bias"):
        out[f"{a}.ln_post.{k}"] = _to_numpy(enc["ln_post"][k])
    for i, p in enumerate(enc["layers"]):
        pre = f"{a}.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _export_linear(p[name], f"{pre}.self_attn.{name}", out)
        for name in ("fc1", "fc2"):
            _export_linear(p[name], f"{pre}.{name}", out)
        for src, dst in (("attn_ln", "self_attn_layer_norm"), ("final_ln", "final_layer_norm")):
            for k in ("weight", "bias"):
                out[f"{pre}.{dst}.{k}"] = _to_numpy(p[src][k])
    emb = dec["embed_tokens"]
    if isinstance(emb, dict):
        _export_linear(emb, "model.embed_tokens", out)
    else:
        out["model.embed_tokens.weight"] = _to_numpy(emb)
    out["model.norm.weight"] = _to_numpy(dec["norm"]["weight"])
    for i, p in enumerate(dec["layers"]):
        pre = f"model.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _export_linear(p[name], f"{pre}.self_attn.{name}", out)
        for name in ("q_norm", "k_norm"):
            out[f"{pre}.self_attn.{name}.weight"] = _to_numpy(p[name]["weight"])
        for name in ("input_layernorm", "post_attention_layernorm"):
            out[f"{pre}.{name}.weight"] = _to_numpy(p[name]["weight"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _export_linear(p["mlp"][name], f"{pre}.mlp.{name}", out)
    return out


def save_checkpoint(flat: dict, model_dir, dtype_of=None) -> None:
    """Write ``flat`` into ``model_dir`` as two safetensors shards: the
    integer arrays (packed codes) through safetensors' numpy writer, the
    float arrays through its torch writer (numpy has no bfloat16), each
    stored as ``dtype_of(name)``, bfloat16 where no rule is given."""
    from pathlib import Path

    from safetensors.numpy import save_file as save_np
    from safetensors.torch import save_file as save_pt

    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    ints = {k: np.ascontiguousarray(v) for k, v in flat.items()
            if not np.issubdtype(v.dtype, np.floating)}
    floats = {k: _tensor(v.astype(np.float32)).to(dtype_of(k) if dtype_of else torch.bfloat16)
              for k, v in flat.items() if np.issubdtype(v.dtype, np.floating)}
    save_np(ints, str(model_dir / "model-00001-of-00002.safetensors"))
    save_pt(floats, str(model_dir / "model-00002-of-00002.safetensors"))
