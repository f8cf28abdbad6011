"""Convert icefall KWS Zipformer checkpoints to the canonical tree.

The upstream checkpoint is icefall's
``pkufool/keyword-spotting-models`` KWS Zipformer (gigaspeech, 3.49M
params) — a torch ``state_dict`` with module paths like
``encoder.encoders.3.encoder.layers.0.self_attn_weights.in_proj.weight``
(reference: Configuration.swift:57-61 records the exact source; the
reference consumes it as precompiled CoreML units, we consume the raw
weights). This converter maps those names onto zipformer.py's canonical
pytree and applies the layout conventions documented there:

- Linear ``weight`` [out, in] → ``kernel`` [in, out]
- Conv2d OIHW → HWIO; depthwise Conv1d [C, 1, W] → [W, 1, C]
- attention ``in_proj`` q-rows pre-scaled by sqrt(query_head_dim)
  (runtime divides scores by sqrt(qd); icefall bakes the scale into
  trained magnitudes)
- decoder grouped conv [D, 4, ctx] → [ctx, 4, D]

Usage::

    python -m qwen3_asr_swift_tpu.models.wakeword.convert \
        --checkpoint pretrained.pt --out-dir kws-zipformer/
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

from .zipformer import ZipformerConfig


def _lin(sd: Dict[str, np.ndarray], prefix: str, bias: bool = True) -> dict:
    out = {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _conv2d(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    # torch OIHW → HWIO
    return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)),
            "b": sd[f"{prefix}.bias"]}


def _dw1d(w: np.ndarray) -> np.ndarray:
    # torch depthwise Conv1d [C, 1, W] → [W, 1, C]
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def _biasnorm(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    return {"bias": sd[f"{prefix}.bias"],
            "log_scale": np.asarray(sd[f"{prefix}.log_scale"]).reshape(())}


def convert_icefall_tree(sd: Dict[str, np.ndarray],
                         cfg: ZipformerConfig | None = None) -> dict:
    """Map a flat icefall state_dict (numpy values) → canonical pytree."""
    cfg = cfg or ZipformerConfig()
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}

    embed = {
        "conv0": _conv2d(sd, "encoder_embed.conv.0"),
        "conv1": _conv2d(sd, "encoder_embed.conv.3"),
        "conv2": _conv2d(sd, "encoder_embed.conv.6"),
        "convnext": {
            "dw": {"w": np.ascontiguousarray(
                       sd["encoder_embed.convnext.depthwise_conv.weight"]
                       .transpose(2, 3, 1, 0)),
                   "b": sd["encoder_embed.convnext.depthwise_conv.bias"]},
            # 1x1 Conv2d [O, I, 1, 1] → linear kernel [I, O]
            "pw1": {"kernel": np.ascontiguousarray(
                        sd["encoder_embed.convnext.pointwise_conv1.weight"][:, :, 0, 0].T),
                    "bias": sd["encoder_embed.convnext.pointwise_conv1.bias"]},
            "pw2": {"kernel": np.ascontiguousarray(
                        sd["encoder_embed.convnext.pointwise_conv2.weight"][:, :, 0, 0].T),
                    "bias": sd["encoder_embed.convnext.pointwise_conv2.bias"]},
        },
        "out": _lin(sd, "encoder_embed.out"),
        "out_norm": _biasnorm(sd, "encoder_embed.out_norm"),
    }

    stacks = []
    for i, n in enumerate(cfg.num_layers):
        ds = cfg.downsampling[i]
        base = f"encoder.encoders.{i}"
        inner = base if ds == 1 else f"{base}.encoder"
        stack: dict = {"layers": []}
        if ds > 1:
            stack["downsample_bias"] = sd[f"{base}.downsample.bias"]
            stack["out_combiner"] = {"bypass_scale": sd[f"{base}.out_combiner.bypass_scale"]}
        for j in range(n):
            lp = f"{inner}.layers.{j}"
            h = cfg.num_heads[i]
            qd, pd = cfg.query_head_dim, cfg.pos_head_dim
            in_proj = _lin(sd, f"{lp}.self_attn_weights.in_proj")
            # pre-scale q columns (kernel is [in, out]; q occupies the first
            # h*qd output columns) by sqrt(qd)
            k = in_proj["kernel"].copy()
            k[:, : h * qd] *= np.sqrt(qd)
            in_proj["kernel"] = k
            if "bias" in in_proj:
                b = in_proj["bias"].copy()
                b[: h * qd] *= np.sqrt(qd)
                in_proj["bias"] = b

            def conv_module(p):
                return {
                    "in_proj": _lin(sd, f"{p}.in_proj"),
                    "causal_w": _dw1d(sd[f"{p}.depthwise_conv.causal_conv.weight"]),
                    "causal_b": sd[f"{p}.depthwise_conv.causal_conv.bias"],
                    "chunkwise_w": _dw1d(sd[f"{p}.depthwise_conv.chunkwise_conv.weight"]),
                    "chunkwise_b": sd[f"{p}.depthwise_conv.chunkwise_conv.bias"],
                    "out_proj": _lin(sd, f"{p}.out_proj"),
                }

            stack["layers"].append({
                "attn_weights": {
                    "in_proj": in_proj,
                    "linear_pos": _lin(sd, f"{lp}.self_attn_weights.linear_pos", bias=False),
                },
                "self_attn1": {"in_proj": _lin(sd, f"{lp}.self_attn1.in_proj"),
                               "out_proj": _lin(sd, f"{lp}.self_attn1.out_proj")},
                "self_attn2": {"in_proj": _lin(sd, f"{lp}.self_attn2.in_proj"),
                               "out_proj": _lin(sd, f"{lp}.self_attn2.out_proj")},
                "nonlin_attention": {"in_proj": _lin(sd, f"{lp}.nonlin_attention.in_proj"),
                                     "out_proj": _lin(sd, f"{lp}.nonlin_attention.out_proj")},
                "conv_module1": conv_module(f"{lp}.conv_module1"),
                "conv_module2": conv_module(f"{lp}.conv_module2"),
                "feed_forward1": {"in_proj": _lin(sd, f"{lp}.feed_forward1.in_proj"),
                                  "out_proj": _lin(sd, f"{lp}.feed_forward1.out_proj")},
                "feed_forward2": {"in_proj": _lin(sd, f"{lp}.feed_forward2.in_proj"),
                                  "out_proj": _lin(sd, f"{lp}.feed_forward2.out_proj")},
                "feed_forward3": {"in_proj": _lin(sd, f"{lp}.feed_forward3.in_proj"),
                                  "out_proj": _lin(sd, f"{lp}.feed_forward3.out_proj")},
                "norm": _biasnorm(sd, f"{lp}.norm"),
                "bypass": {"bypass_scale": sd[f"{lp}.bypass.bypass_scale"]},
                "bypass_mid": {"bypass_scale": sd[f"{lp}.bypass_mid.bypass_scale"]},
            })
        stacks.append(stack)

    params = {
        "embed": embed,
        "stacks": stacks,
        "downsample_output_bias": sd["encoder.downsample_output.bias"],
        "encoder_proj": _lin(sd, "joiner.encoder_proj"),
        "decoder": {
            "embedding": sd["decoder.embedding.weight"],
            # torch grouped Conv1d [D, 4, ctx] → [ctx, 4, D]
            "conv_w": np.ascontiguousarray(sd["decoder.conv.weight"].transpose(2, 1, 0)),
        },
        "joiner": {
            "decoder_proj": _lin(sd, "joiner.decoder_proj"),
            "output_linear": _lin(sd, "joiner.output_linear"),
        },
    }
    return params


def export_icefall_state_dict(params: dict, cfg: ZipformerConfig) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_icefall_tree` — build a synthetic icefall
    state_dict from a canonical tree (used by round-trip tests)."""
    sd: Dict[str, np.ndarray] = {}

    def put_lin(prefix, p, scale_q=None):
        k = np.asarray(p["kernel"])
        if scale_q is not None:
            k = k.copy()
            k[:, :scale_q[0]] /= scale_q[1]
        sd[f"{prefix}.weight"] = np.ascontiguousarray(k.T)
        if "bias" in p:
            b = np.asarray(p["bias"])
            if scale_q is not None:
                b = b.copy()
                b[: scale_q[0]] /= scale_q[1]
            sd[f"{prefix}.bias"] = b

    e = params["embed"]
    for name, key in (("0", "conv0"), ("3", "conv1"), ("6", "conv2")):
        sd[f"encoder_embed.conv.{name}.weight"] = np.ascontiguousarray(
            np.asarray(e[key]["w"]).transpose(3, 2, 0, 1))
        sd[f"encoder_embed.conv.{name}.bias"] = np.asarray(e[key]["b"])
    cn = e["convnext"]
    sd["encoder_embed.convnext.depthwise_conv.weight"] = np.ascontiguousarray(
        np.asarray(cn["dw"]["w"]).transpose(3, 2, 0, 1))
    sd["encoder_embed.convnext.depthwise_conv.bias"] = np.asarray(cn["dw"]["b"])
    for pw in ("pw1", "pw2"):
        t = "pointwise_conv1" if pw == "pw1" else "pointwise_conv2"
        sd[f"encoder_embed.convnext.{t}.weight"] = np.ascontiguousarray(
            np.asarray(cn[pw]["kernel"]).T)[:, :, None, None]
        sd[f"encoder_embed.convnext.{t}.bias"] = np.asarray(cn[pw]["bias"])
    put_lin("encoder_embed.out", e["out"])
    sd["encoder_embed.out_norm.bias"] = np.asarray(e["out_norm"]["bias"])
    sd["encoder_embed.out_norm.log_scale"] = np.asarray(e["out_norm"]["log_scale"])

    for i, stack in enumerate(params["stacks"]):
        ds = cfg.downsampling[i]
        base = f"encoder.encoders.{i}"
        inner = base if ds == 1 else f"{base}.encoder"
        if ds > 1:
            sd[f"{base}.downsample.bias"] = np.asarray(stack["downsample_bias"])
            sd[f"{base}.out_combiner.bypass_scale"] = np.asarray(
                stack["out_combiner"]["bypass_scale"])
        for j, lp_params in enumerate(stack["layers"]):
            lp = f"{inner}.layers.{j}"
            h, qd = cfg.num_heads[i], cfg.query_head_dim
            put_lin(f"{lp}.self_attn_weights.in_proj",
                    lp_params["attn_weights"]["in_proj"],
                    scale_q=(h * qd, np.sqrt(qd)))
            put_lin(f"{lp}.self_attn_weights.linear_pos",
                    lp_params["attn_weights"]["linear_pos"])
            for mod in ("self_attn1", "self_attn2", "nonlin_attention"):
                put_lin(f"{lp}.{mod}.in_proj", lp_params[mod]["in_proj"])
                put_lin(f"{lp}.{mod}.out_proj", lp_params[mod]["out_proj"])
            for mod in ("conv_module1", "conv_module2"):
                cm = lp_params[mod]
                put_lin(f"{lp}.{mod}.in_proj", cm["in_proj"])
                put_lin(f"{lp}.{mod}.out_proj", cm["out_proj"])
                sd[f"{lp}.{mod}.depthwise_conv.causal_conv.weight"] = \
                    np.ascontiguousarray(np.asarray(cm["causal_w"]).transpose(2, 1, 0))
                sd[f"{lp}.{mod}.depthwise_conv.causal_conv.bias"] = np.asarray(cm["causal_b"])
                sd[f"{lp}.{mod}.depthwise_conv.chunkwise_conv.weight"] = \
                    np.ascontiguousarray(np.asarray(cm["chunkwise_w"]).transpose(2, 1, 0))
                sd[f"{lp}.{mod}.depthwise_conv.chunkwise_conv.bias"] = np.asarray(cm["chunkwise_b"])
            for mod in ("feed_forward1", "feed_forward2", "feed_forward3"):
                put_lin(f"{lp}.{mod}.in_proj", lp_params[mod]["in_proj"])
                put_lin(f"{lp}.{mod}.out_proj", lp_params[mod]["out_proj"])
            sd[f"{lp}.norm.bias"] = np.asarray(lp_params["norm"]["bias"])
            sd[f"{lp}.norm.log_scale"] = np.asarray(lp_params["norm"]["log_scale"])
            sd[f"{lp}.bypass.bypass_scale"] = np.asarray(lp_params["bypass"]["bypass_scale"])
            sd[f"{lp}.bypass_mid.bypass_scale"] = np.asarray(lp_params["bypass_mid"]["bypass_scale"])

    sd["encoder.downsample_output.bias"] = np.asarray(params["downsample_output_bias"])
    put_lin("joiner.encoder_proj", params["encoder_proj"])
    sd["decoder.embedding.weight"] = np.asarray(params["decoder"]["embedding"])
    sd["decoder.conv.weight"] = np.ascontiguousarray(
        np.asarray(params["decoder"]["conv_w"]).transpose(2, 1, 0))
    put_lin("joiner.decoder_proj", params["joiner"]["decoder_proj"])
    put_lin("joiner.output_linear", params["joiner"]["output_linear"])
    return sd


def convert_checkpoint(checkpoint: str, out_dir: str,
                       cfg: ZipformerConfig | None = None) -> Path:
    """Read an icefall ``pretrained.pt``/``.safetensors`` checkpoint and
    write ``<out_dir>/model.safetensors`` (canonical flat tree) +
    ``config.json``."""
    import dataclasses as dc

    from safetensors.numpy import save_file

    from ...core.weights import flatten

    cfg = cfg or ZipformerConfig()
    path = Path(checkpoint)
    if path.suffix == ".safetensors":
        from safetensors import safe_open

        with safe_open(str(path), framework="np") as f:
            sd = {k: f.get_tensor(k) for k in f.keys()}
    else:
        import torch

        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "model" in raw:
            raw = raw["model"]
        sd = {k: v.numpy() for k, v in raw.items()
              if hasattr(v, "numpy") and v.dtype.is_floating_point}
    params = convert_icefall_tree(sd, cfg)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_file({k: np.asarray(v) for k, v in flatten(_listed(params)).items()},
              str(out / "model.safetensors"))
    (out / "config.json").write_text(json.dumps(dc.asdict(cfg), indent=2))
    return out


def _listed(tree):
    """dict-ify lists so the tree flattens to dotted names with indices."""
    if isinstance(tree, list):
        return {str(i): _listed(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _listed(v) for k, v in tree.items()}
    return tree


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args()
    print(convert_checkpoint(args.checkpoint, args.out_dir))
