"""FireRedVAD / FSMN-VAD checkpoint conversion.

Maps the published FSMN-VAD torch state dict (the FunASR encoder layout
FireRedVAD derives from; the reference consumes the same network as an
opaque CoreML artifact — Sources/SpeechVAD/FireRedVAD.swift:79-118) onto
the canonical tree in ``model.py``:

  in_linear1.linear.{weight,bias}            → in1   (affine, torch [out,in])
  in_linear2.linear.{weight,bias}            → in2
  fsmn.{i}.linear.linear.weight              → blocks[i].linear   (no bias)
  fsmn.{i}.fsmn_block.conv_left.weight       → blocks[i].conv_left
      (torch depthwise Conv2d [D,1,taps,1] → [taps,1,D])
  fsmn.{i}.fsmn_block.conv_right.weight      → blocks[i].conv_right (optional)
  fsmn.{i}.affine.linear.{weight,bias}       → blocks[i].affine
  out_linear1.linear.{weight,bias}           → out1
  out_linear2.linear.{weight,bias}           → out2

Every dimension of the ``FireRedVADConfig`` is inferred from the tensor
shapes, so size variants load without config edits.  Accepted containers:
``*.safetensors``, torch ``*.pt/*.pth/*.pb`` pickles (incl. ``{"state_dict"}``
wrappers); common prefixes (``encoder.``, ``model.``, ``module.``) are
stripped.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .model import CONFIG_FIRERED, FireRedVADConfig

_PREFIXES = ("module.", "model.", "encoder.")


def _strip(key: str) -> str:
    changed = True
    while changed:
        changed = False
        for p in _PREFIXES:
            if key.startswith(p):
                key = key[len(p):]
                changed = True
    return key


def _load_state_dict(src: Path) -> Dict[str, np.ndarray]:
    if src.is_dir():
        cands = (sorted(src.glob("*.safetensors")) + sorted(src.glob("*.pt"))
                 + sorted(src.glob("*.pth")) + sorted(src.glob("*.pb")))
        if not cands:
            raise FileNotFoundError(f"no checkpoint under {src}")
        src = cands[0]
    if src.suffix == ".safetensors":
        from safetensors.numpy import load_file

        raw = load_file(str(src))
    else:
        import torch

        obj = torch.load(str(src), map_location="cpu", weights_only=True)
        for key in ("state_dict", "model", "model_state_dict"):
            if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
        raw = {k: v.detach().cpu().float().numpy() for k, v in obj.items()
               if hasattr(v, "detach")}
    return {_strip(k): np.asarray(v, np.float32) for k, v in raw.items()}


def _affine(sd, prefix: str) -> dict:
    w = sd[f"{prefix}.linear.weight"]
    p = {"kernel": np.ascontiguousarray(w.T)}
    if f"{prefix}.linear.bias" in sd:
        p["bias"] = sd[f"{prefix}.linear.bias"]
    return p


def _memory(w: np.ndarray) -> np.ndarray:
    """torch depthwise Conv2d weight [D,1,taps,1] (or Conv1d [D,1,taps])
    → [taps,1,D]."""
    w = np.squeeze(w)          # [D, taps]
    return np.ascontiguousarray(w.T)[:, None, :]


def map_fsmn_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[FireRedVADConfig, dict]:
    n_blocks = 0
    while f"fsmn.{n_blocks}.linear.linear.weight" in sd:
        n_blocks += 1
    if n_blocks == 0:
        raise KeyError("no fsmn.{i}.linear.linear.weight keys — not an FSMN-VAD checkpoint")

    in1 = _affine(sd, "in_linear1")
    in2 = _affine(sd, "in_linear2")
    out1 = _affine(sd, "out_linear1")
    out2 = _affine(sd, "out_linear2")

    blocks = []
    lorder = rorder = 0
    for i in range(n_blocks):
        block = {
            "linear": {"kernel": np.ascontiguousarray(
                sd[f"fsmn.{i}.linear.linear.weight"].T)},
            "conv_left": _memory(sd[f"fsmn.{i}.fsmn_block.conv_left.weight"]),
            "affine": _affine(sd, f"fsmn.{i}.affine"),
        }
        lorder = block["conv_left"].shape[0]
        right = sd.get(f"fsmn.{i}.fsmn_block.conv_right.weight")
        if right is not None:
            block["conv_right"] = _memory(right)
            rorder = block["conv_right"].shape[0]
        blocks.append(block)

    input_dim = in1["kernel"].shape[0]
    base = CONFIG_FIRERED
    lfr_m = max(1, input_dim // base.num_mels)
    cfg = dataclasses.replace(
        base,
        lfr_m=lfr_m,
        in_affine=in1["kernel"].shape[1],
        linear_dim=in2["kernel"].shape[1],
        proj_dim=blocks[0]["linear"]["kernel"].shape[1],
        num_blocks=n_blocks,
        lorder=lorder,
        rorder=rorder,
        out_affine=out1["kernel"].shape[1],
        output_dim=out2["kernel"].shape[1],
    )
    params = {"in1": in1, "in2": in2, "blocks": blocks, "out1": out1, "out2": out2}
    return cfg, params


def convert_checkpoint(src) -> Tuple[FireRedVADConfig, dict]:
    """Load + map an upstream FSMN-VAD checkpoint directory or file."""
    return map_fsmn_state_dict(_load_state_dict(Path(src)))
