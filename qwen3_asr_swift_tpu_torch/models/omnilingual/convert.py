"""wav2vec2/Omnilingual checkpoint conversion (HF layout)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .model import CONV_SPEC, OmniConfig


def convert_wav2vec2(flat: Dict[str, np.ndarray], cfg: OmniConfig) -> dict:
    f = {k.replace("wav2vec2.", ""): v for k, v in flat.items()}

    def lin(name):
        p = {"kernel": np.ascontiguousarray(f[f"{name}.weight"].T).astype(np.float32)}
        if f"{name}.bias" in f:
            p["bias"] = f[f"{name}.bias"].astype(np.float32)
        return p

    def ln(name):
        return {"weight": f[f"{name}.weight"].astype(np.float32),
                "bias": f[f"{name}.bias"].astype(np.float32)}

    params = {"feature_extractor": [], "layers": []}
    for i in range(len(CONV_SPEC)):
        base = f"feature_extractor.conv_layers.{i}"
        params["feature_extractor"].append({
            "kernel": np.transpose(f[f"{base}.conv.weight"], (2, 1, 0)).astype(np.float32),
            "ln": ln(f"{base}.layer_norm"),
        })
    params["feature_projection"] = {
        "ln": ln("feature_projection.layer_norm"),
        "proj": lin("feature_projection.projection"),
    }
    base = "encoder.pos_conv_embed.conv"
    if f"{base}.weight" in f:
        pos_w = f[f"{base}.weight"]
    elif f"{base}.weight_g" in f:  # legacy torch weight-norm split
        g, v = f[f"{base}.weight_g"], f[f"{base}.weight_v"]
        pos_w = g * v / np.linalg.norm(v, axis=(0, 1), keepdims=True)
    else:  # torch >= 2.1 parametrize-style weight norm
        g = f[f"{base}.parametrizations.weight.original0"]
        v = f[f"{base}.parametrizations.weight.original1"]
        pos_w = g * v / np.linalg.norm(v, axis=(0, 1), keepdims=True)
    params["pos_conv"] = {
        "kernel": np.transpose(pos_w, (2, 1, 0)).astype(np.float32),
        "bias": f["encoder.pos_conv_embed.conv.bias"].astype(np.float32),
    }
    params["encoder_ln"] = ln("encoder.layer_norm")
    for i in range(cfg.num_layers):
        b = f"encoder.layers.{i}"
        params["layers"].append({
            "attn": {"q": lin(f"{b}.attention.q_proj"), "k": lin(f"{b}.attention.k_proj"),
                     "v": lin(f"{b}.attention.v_proj"), "o": lin(f"{b}.attention.out_proj")},
            "ln1": ln(f"{b}.layer_norm"),
            "ff1": lin(f"{b}.feed_forward.intermediate_dense"),
            "ff2": lin(f"{b}.feed_forward.output_dense"),
            "ln2": ln(f"{b}.final_layer_norm"),
        })
    params["ctc_head"] = lin("lm_head") if "lm_head.weight" in f else lin("ctc_head")
    return params
