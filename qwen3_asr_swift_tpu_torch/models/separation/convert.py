"""Open-Unmix checkpoint conversion (torchhub UMX-HQ per-stem .pth files)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from .model import STEMS


def _convert_stem(sd: Dict[str, np.ndarray]) -> dict:
    def lin(name):
        return {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T).astype(np.float32)}

    def bn(name, eps=1e-5):
        scale = sd[f"{name}.weight"] / np.sqrt(sd[f"{name}.running_var"] + eps)
        return {"scale": scale.astype(np.float32),
                "bias": (sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * scale).astype(np.float32)}

    def lstm(direction, layer):
        sfx = "_reverse" if direction == "bwd" else ""
        wi = sd[f"lstm.weight_ih_l{layer}{sfx}"]
        wh = sd[f"lstm.weight_hh_l{layer}{sfx}"]
        bi = sd.get(f"lstm.bias_ih_l{layer}{sfx}", 0)
        bh = sd.get(f"lstm.bias_hh_l{layer}{sfx}", 0)
        return {
            "wx": np.ascontiguousarray(wi.T).astype(np.float32),
            "wh": np.ascontiguousarray(wh.T).astype(np.float32),
            "bias": np.asarray(bi + bh, np.float32),
        }

    return {
        "input_mean": sd["input_mean"].astype(np.float32),
        "input_scale": sd["input_scale"].astype(np.float32),
        "fc1": lin("fc1"),
        "bn1": bn("bn1"),
        "lstm_fwd": [lstm("fwd", i) for i in range(3)],
        "lstm_bwd": [lstm("bwd", i) for i in range(3)],
        "fc2": lin("fc2"),
        "bn2": bn("bn2"),
        "fc3": lin("fc3"),
        "bn3": bn("bn3"),
        "output_scale": sd["output_scale"].astype(np.float32),
        "output_mean": sd["output_mean"].astype(np.float32),
    }


def load_umx_checkpoint(model_dir) -> Dict[str, dict]:
    model_dir = Path(model_dir)
    out = {}
    for stem in STEMS:
        candidates = list(model_dir.glob(f"{stem}*.pth")) + list(model_dir.glob(f"{stem}*.safetensors"))
        if not candidates:
            continue
        path = candidates[0]
        if path.suffix == ".pth":
            import torch  # only the .pth branch needs torch

            sd = torch.load(str(path), map_location="cpu", weights_only=True)
            sd = {k: v.float().numpy() for k, v in sd.items()}
        else:
            # load ONLY this stem's file — loading the directory would
            # merge all four stems' identically-named keys into one dict
            # (every stem silently converted from whichever file won)
            from safetensors.numpy import load_file

            sd = load_file(str(path))
        out[stem] = _convert_stem(sd)
    if not out:
        raise FileNotFoundError(f"no stem checkpoints in {model_dir}")
    return out
