"""DeepFilterNet3 checkpoint conversion.

Maps the upstream DeepFilterNet torch checkpoint (state-dict prefixes
``enc.`` / ``erb_dec.`` / ``df_dec.``, ``Conv2dNormAct`` blocks stored as
``nn.Sequential`` with position-dependent indices) onto the canonical
parameter tree consumed by ``dfn3.py``.  The reference consumes the same
network as an opaque CoreML artifact plus an ``auxiliary.npz`` holding the
ERB filterbank / window / normalization-state constants
(reference: Sources/SpeechEnhancement/WeightLoading.swift:24-77); here the
aux constants are recomputed from the published formulas and the
normalization initializers are taken from ``auxiliary.npz`` when present.

Layout rules handled (mirroring how upstream ``Conv2dNormAct`` is assembled):
  * an optional leading ``ConstantPad2d`` shifts all indices by one — we
    therefore identify roles by tensor shape, not by fixed index:
    the first 4-D weight is the main conv, a second 4-D ``(O,O,1,1)``
    weight is the separable pointwise conv, and the index owning
    ``running_mean`` is the BatchNorm,
  * ``ConvTranspose2d`` weights ``(I, O/g, kH, kW)`` are re-expressed as
    OIHW grouped-conv weights with frequency taps flipped (the lhs-dilated
    formulation in ``conv_transpose_norm_act``),
  * ``nn.GRU`` tensors ``weight_ih_l{k}/weight_hh_l{k}/bias_*`` map to
    per-layer ``wi/wh/bi/bh`` with torch (r,z,n) gate order preserved,
  * ``GroupedLinearEinsum`` weights ``[groups, in/g, out/g]`` copy verbatim.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .dfn3 import CONV_CH


def _load_state_dict(path: Path) -> Dict[str, np.ndarray]:
    """Read a torch pickle / safetensors checkpoint into numpy arrays."""
    if path.suffix == ".safetensors":
        from safetensors.numpy import load_file

        return {k.replace("module.", ""): v for k, v in load_file(str(path)).items()}
    import torch

    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    for key in ("model", "model_state_dict", "state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            out[k.replace("module.", "")] = v.detach().cpu().float().numpy()
    return out


def _index_groups(sd: Dict[str, np.ndarray], prefix: str):
    """Split ``prefix.<i>.<leaf>`` keys into per-index {leaf: tensor} dicts,
    ordered by i."""
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.(.+)$")
    groups: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        m = pat.match(k)
        if m:
            groups.setdefault(int(m.group(1)), {})[m.group(2)] = v
    return [groups[i] for i in sorted(groups)]


def _conv_block(sd, prefix: str, *, transpose: bool = False) -> dict:
    """Parse one Conv2dNormAct / ConvTranspose2dNormAct Sequential."""
    convs, bn = [], None
    for leaves in _index_groups(sd, prefix):
        if "running_mean" in leaves:
            bn = {"scale": leaves["weight"], "bias": leaves["bias"],
                  "mean": leaves["running_mean"], "var": leaves["running_var"]}
        elif "weight" in leaves and leaves["weight"].ndim == 4:
            convs.append(leaves)
    if not convs:
        raise KeyError(f"no conv weight under {prefix!r}")
    out = {}
    main = convs[0]
    w = main["weight"]
    if transpose:
        # torch (I, O/g, kH, kW), depthwise g=I → OIHW with freq taps flipped
        w = np.ascontiguousarray(w[..., ::-1])
    out["w"] = w
    if "bias" in main:
        out["b"] = main["bias"]
    if len(convs) > 1:
        out["pw"] = convs[1]["weight"]
    if bn is not None:
        out["bn"] = bn
    return out


def _gru_stack(sd, prefix: str, *, has_out: bool) -> dict:
    lin_in = sd[f"{prefix}.linear_in.0.weight"]
    layers = []
    for k in range(8):
        key = f"{prefix}.gru.weight_ih_l{k}"
        if key not in sd:
            break
        layers.append({
            "wi": sd[key],
            "wh": sd[f"{prefix}.gru.weight_hh_l{k}"],
            "bi": sd.get(f"{prefix}.gru.bias_ih_l{k}",
                         np.zeros(sd[key].shape[0], np.float32)),
            "bh": sd.get(f"{prefix}.gru.bias_hh_l{k}",
                         np.zeros(sd[key].shape[0], np.float32)),
        })
    p = {"lin_in": lin_in, "gru": tuple(layers)}
    if has_out:
        p["lin_out"] = sd[f"{prefix}.linear_out.0.weight"]
    return p


def map_dfn3_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """Upstream DeepFilterNet3 state dict → canonical dfn3 parameter tree."""
    c = CONV_CH
    enc = {
        "erb_conv0": _conv_block(sd, "enc.erb_conv0"),
        "erb_conv1": _conv_block(sd, "enc.erb_conv1"),
        "erb_conv2": _conv_block(sd, "enc.erb_conv2"),
        "erb_conv3": _conv_block(sd, "enc.erb_conv3"),
        "df_conv0": _conv_block(sd, "enc.df_conv0"),
        "df_conv1": _conv_block(sd, "enc.df_conv1"),
        "df_fc_emb": sd["enc.df_fc_emb.0.weight"],
        "emb_gru": _gru_stack(sd, "enc.emb_gru", has_out=True),
        "lsnr": {"w": sd["enc.lsnr_fc.0.weight"], "b": sd["enc.lsnr_fc.0.bias"]},
    }
    erb_dec = {
        "emb_gru": _gru_stack(sd, "erb_dec.emb_gru", has_out=True),
        "conv3p": _conv_block(sd, "erb_dec.conv3p"),
        "convt3": _conv_block(sd, "erb_dec.convt3"),
        "conv2p": _conv_block(sd, "erb_dec.conv2p"),
        "convt2": _conv_block(sd, "erb_dec.convt2", transpose=True),
        "conv1p": _conv_block(sd, "erb_dec.conv1p"),
        "convt1": _conv_block(sd, "erb_dec.convt1", transpose=True),
        "conv0p": _conv_block(sd, "erb_dec.conv0p"),
        "conv0_out": _conv_block(sd, "erb_dec.conv0_out"),
    }
    df_dec = {
        "df_gru": _gru_stack(sd, "df_dec.df_gru", has_out=False),
        "df_out": sd["df_dec.df_out.0.weight"],
        "df_convp": _conv_block(sd, "df_dec.df_convp"),
    }
    # sanity: channel widths must match the pinned config
    assert enc["erb_conv0"]["w"].shape[0] == c, enc["erb_conv0"]["w"].shape
    return {"enc": enc, "erb_dec": erb_dec, "df_dec": df_dec}


def convert_checkpoint(src) -> Tuple[dict, dict]:
    """Convert an upstream DeepFilterNet3 checkpoint (directory or file)
    into the canonical dfn3 parameter tree.  Returns ``(params, aux)`` where
    ``aux`` holds normalization-state initializers from ``auxiliary.npz``
    when present (the reference loads the same two arrays,
    WeightLoading.swift:43-62)."""
    src = Path(src)
    ckpt = src
    if src.is_dir():
        cands = (sorted(src.glob("**/*.ckpt.best")) + sorted(src.glob("**/*.ckpt"))
                 + sorted(src.glob("**/*.pth")) + sorted(src.glob("**/*.pt"))
                 + sorted(src.glob("**/*.safetensors")))
        if not cands:
            raise FileNotFoundError(f"no checkpoint under {src}")
        ckpt = cands[0]
    params = map_dfn3_state_dict(_load_state_dict(ckpt))

    aux = {}
    aux_src = (src if src.is_dir() else src.parent) / "auxiliary.npz"
    if aux_src.exists():
        with np.load(aux_src) as z:
            for key in ("mean_norm_state", "unit_norm_state"):
                if key in z:
                    aux[key] = z[key].astype(np.float32).reshape(-1)
    return params, aux
