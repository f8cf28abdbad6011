"""WeSpeaker checkpoint conversion (torch ResNet34 state dict → param tree).

Batch norms fold to scale/shift at load (inference only). Key layout
follows the wespeaker-project ResNet34 release (front.conv1, layerN.M.*,
pooling → seg_1 bottleneck linear).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _fold_bn(sd, prefix, eps=1e-5):
    w = sd[f"{prefix}.weight"]
    b = sd[f"{prefix}.bias"]
    m = sd[f"{prefix}.running_mean"]
    v = sd[f"{prefix}.running_var"]
    scale = w / np.sqrt(v + eps)
    return {"scale": scale.astype(np.float32), "bias": (b - m * scale).astype(np.float32)}


def _conv(sd, name):
    # torch OIHW with H=freq, W=time (wespeaker feeds [B, 1, F, T]); our
    # forward is NHWC with H=time, W=mel — swap the spatial axes too
    return {"kernel": np.transpose(sd[f"{name}.weight"], (3, 2, 1, 0)).astype(np.float32)}


def convert_wespeaker(sd: Dict[str, np.ndarray], blocks=(3, 4, 6, 3)) -> dict:
    params = {
        "stem": {"conv": _conv(sd, "front.conv1" if "front.conv1.weight" in sd else "conv1"),
                 "bn": _fold_bn(sd, "front.bn1" if "front.bn1.weight" in sd else "bn1")},
        "stages": [],
    }
    for si, nb in enumerate(blocks):
        stage = []
        for bi in range(nb):
            base = f"layer{si + 1}.{bi}"
            blk = {
                "conv1": _conv(sd, f"{base}.conv1"),
                "bn1": _fold_bn(sd, f"{base}.bn1"),
                "conv2": _conv(sd, f"{base}.conv2"),
                "bn2": _fold_bn(sd, f"{base}.bn2"),
                "stride": 2 if (bi == 0 and si > 0) else 1,
            }
            if f"{base}.downsample.0.weight" in sd:
                blk["down"] = _conv(sd, f"{base}.downsample.0")
                blk["down_bn"] = _fold_bn(sd, f"{base}.downsample.1")
            stage.append(blk)
        params["stages"].append(stage)
    seg = "seg_1" if "seg_1.weight" in sd else "embed"
    w = sd[f"{seg}.weight"].astype(np.float32)          # [emb, 2*C*F]
    # upstream TSTP flattens [C, F'] channel-major before seg_1; our pooled
    # vector is freq-major ([F', C] reshape).  Our column j = f*C + c must
    # read upstream column c*F + f, applied to the mean and std halves.
    half = w.shape[1] // 2
    c_key = f"layer4.{blocks[3] - 1}.conv2.weight"
    c_last = sd[c_key].shape[0] if c_key in sd else None
    if c_last and half % c_last == 0:
        f_out = half // c_last
        j = np.arange(half)
        src = (j % c_last) * f_out + (j // c_last)
        w = np.concatenate([w[:, :half][:, src], w[:, half:][:, src]], axis=1)
    params["embed"] = {
        "kernel": np.ascontiguousarray(w.T),
        "bias": sd.get(f"{seg}.bias", np.zeros(w.shape[0])).astype(np.float32),
    }
    return params
