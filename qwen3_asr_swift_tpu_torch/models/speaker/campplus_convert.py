"""CAM++ checkpoint conversion (3D-Speaker torch naming).

Maps the published ``campplus_cn_common`` state dict (the torch model the
reference's CoreML artifact is exported from —
Sources/CosyVoiceTTS/CamPlusPlusSpeaker.swift consumes only the export)
onto the canonical tree in ``campplus.py``:

  head.conv1/bn1, head.layer{1,2}.{i}.{conv1,bn1,conv2,bn2,shortcut.0/1},
  head.conv2/bn2
  xvector.tdnn.{linear, nonlinear.batchnorm}
  xvector.block{b}.tdnnd{j}.{nonlinear1.batchnorm, linear1,
      nonlinear2.batchnorm, cam_layer.{linear_local, linear1, linear2}}
  xvector.transit{b}.{nonlinear.batchnorm, linear}
  xvector.out_nonlinear.batchnorm
  xvector.dense.{linear, nonlinear.batchnorm (affine-free)}

Block/layer counts and channel widths are inferred from the keys."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .campplus import CONFIG_CAMPPLUS, CampPlusConfig


def _load_state_dict(src: Path) -> Dict[str, np.ndarray]:
    if src.is_dir():
        cands = (sorted(src.glob("*.safetensors")) + sorted(src.glob("*.bin"))
                 + sorted(src.glob("*.pt")) + sorted(src.glob("*.pth")))
        if not cands:
            raise FileNotFoundError(f"no checkpoint under {src}")
        src = cands[0]
    if src.suffix == ".safetensors":
        from safetensors.numpy import load_file

        raw = load_file(str(src))
    else:
        import torch

        obj = torch.load(str(src), map_location="cpu", weights_only=True)
        for k in ("state_dict", "model"):
            if isinstance(obj, dict) and k in obj and isinstance(obj[k], dict):
                obj = obj[k]
        raw = {k: v.detach().cpu().float().numpy() for k, v in obj.items()
               if hasattr(v, "detach")}
    return {k.replace("module.", ""): np.asarray(v, np.float32) for k, v in raw.items()}


def _bn(sd, name):
    p = {"mean": sd[f"{name}.running_mean"], "var": sd[f"{name}.running_var"]}
    if f"{name}.weight" in sd:
        p["scale"] = sd[f"{name}.weight"]
        p["bias"] = sd[f"{name}.bias"]
    return p


def _c1(sd, name, bias=True):
    p = {"w": sd[f"{name}.weight"]}
    if bias and f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _res_layer(sd, prefix):
    blocks = []
    i = 0
    while f"{prefix}.{i}.conv1.weight" in sd:
        p = {"conv1": sd[f"{prefix}.{i}.conv1.weight"],
             "bn1": _bn(sd, f"{prefix}.{i}.bn1"),
             "conv2": sd[f"{prefix}.{i}.conv2.weight"],
             "bn2": _bn(sd, f"{prefix}.{i}.bn2")}
        if f"{prefix}.{i}.shortcut.0.weight" in sd:
            p["shortcut_w"] = sd[f"{prefix}.{i}.shortcut.0.weight"]
            p["shortcut_bn"] = _bn(sd, f"{prefix}.{i}.shortcut.1")
        blocks.append(p)
        i += 1
    return blocks


def map_campplus_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[CampPlusConfig, dict]:
    if "head.conv1.weight" not in sd:
        raise KeyError("not a CAM++ state dict (head.conv1.weight missing)")
    head = {
        "conv1": sd["head.conv1.weight"], "bn1": _bn(sd, "head.bn1"),
        "layer1": _res_layer(sd, "head.layer1"),
        "layer2": _res_layer(sd, "head.layer2"),
        "conv2": sd["head.conv2.weight"], "bn2": _bn(sd, "head.bn2"),
    }
    tdnn = {"linear": _c1(sd, "xvector.tdnn.linear"),
            "nonlinear": _bn(sd, "xvector.tdnn.nonlinear.batchnorm")}

    blocks, transits, dilations, layer_counts = [], [], [], []
    b = 1
    while f"xvector.block{b}.tdnnd1.linear1.weight" in sd:
        block = []
        j = 1
        while f"xvector.block{b}.tdnnd{j}.linear1.weight" in sd:
            l = f"xvector.block{b}.tdnnd{j}"
            block.append({
                "nonlinear1": _bn(sd, f"{l}.nonlinear1.batchnorm"),
                "linear1": sd[f"{l}.linear1.weight"],
                "nonlinear2": _bn(sd, f"{l}.nonlinear2.batchnorm"),
                "cam": {"linear_local": _c1(sd, f"{l}.cam_layer.linear_local"),
                        "linear1": _c1(sd, f"{l}.cam_layer.linear1"),
                        "linear2": _c1(sd, f"{l}.cam_layer.linear2")},
            })
            j += 1
        blocks.append(block)
        layer_counts.append(j - 1)
        transits.append({"nonlinear": _bn(sd, f"xvector.transit{b}.nonlinear.batchnorm"),
                         "linear": sd[f"xvector.transit{b}.linear.weight"]})
        b += 1

    dense = {"linear": _c1(sd, "xvector.dense.linear"),
             "nonlinear": _bn(sd, "xvector.dense.nonlinear.batchnorm")}

    m = sd["head.conv1.weight"].shape[0]
    growth = blocks[0][0]["cam"]["linear_local"]["w"].shape[0]
    bn_ch = blocks[0][0]["linear1"].shape[0]
    head_out = sd["xvector.tdnn.linear.weight"].shape[1]
    kernel = blocks[0][0]["cam"]["linear_local"]["w"].shape[-1]
    cfg = dataclasses.replace(
        CONFIG_CAMPPLUS,
        feat_dim=head_out // m * 8,
        embedding_size=dense["linear"]["w"].shape[0],
        growth_rate=growth,
        bn_size=bn_ch // growth,
        init_channels=sd["xvector.tdnn.linear.weight"].shape[0],
        m_channels=m,
        block_layers=tuple(layer_counts),
        block_dilations=CONFIG_CAMPPLUS.block_dilations[: len(layer_counts)]
        if len(layer_counts) <= len(CONFIG_CAMPPLUS.block_dilations)
        else tuple([1] + [2] * (len(layer_counts) - 1)),
        kernel_size=kernel,
    )
    params = {"head": head, "tdnn": tdnn, "blocks": blocks, "transits": transits,
              "out_nonlinear": _bn(sd, "xvector.out_nonlinear.batchnorm"),
              "dense": dense}
    return cfg, params


def convert_checkpoint(src) -> Tuple[CampPlusConfig, dict]:
    return map_campplus_state_dict(_load_state_dict(Path(src)))
