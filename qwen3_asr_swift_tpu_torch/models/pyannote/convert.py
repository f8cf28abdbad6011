"""Pyannote segmentation-3.0 checkpoint → param tree.

The published pyannote checkpoint is a torch state dict (sincnet.conv1d.*
with precomputed sinc filters after the reference's conversion step,
lstm.weight_ih_l{i}(_reverse), linear.*, classifier.*) — reference:
Sources/SpeechVAD/WeightLoading.swift maps the same names onto MLX
modules; here onto the jnp tree in :mod:`.model`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .model import SegmentationConfig


def _lstm_layer(sd: Dict[str, np.ndarray], i: int, reverse: bool) -> dict:
    sfx = "_reverse" if reverse else ""
    wx = sd[f"lstm.weight_ih_l{i}{sfx}"]      # [4h, in]
    wh = sd[f"lstm.weight_hh_l{i}{sfx}"]      # [4h, h]
    b = sd.get(f"lstm.bias_ih_l{i}{sfx}", 0) + sd.get(f"lstm.bias_hh_l{i}{sfx}", 0)
    return {
        "wx": np.ascontiguousarray(wx.T).astype(np.float32),
        "wh": np.ascontiguousarray(wh.T).astype(np.float32),
        "bias": np.asarray(b, np.float32).reshape(-1),
    }


def convert_segmentation(sd: Dict[str, np.ndarray], cfg: SegmentationConfig) -> dict:
    params = {"conv": [], "lstm_fwd": [], "lstm_bwd": [], "linear": []}
    # affine wave-level instance norm (pyannote InstanceNorm1d(1, affine=True))
    if "sincnet.wav_norm1d.weight" in sd:
        params["wav_norm"] = {
            "scale": sd["sincnet.wav_norm1d.weight"].astype(np.float32),
            "bias": sd["sincnet.wav_norm1d.bias"].astype(np.float32)}
    for i in range(len(cfg.sincnet_filters)):
        # torch conv1d [out, in, k] → [k, in, out]; layer 0 may come from the
        # sincnet filterbank export (same layout after materialization)
        for name in (f"sincnet.conv1d.{i}", f"conv.{i}"):
            if f"{name}.weight" in sd:
                w = sd[f"{name}.weight"]
                conv_p = {
                    "kernel": np.transpose(w, (2, 1, 0)).astype(np.float32),
                    "bias": sd.get(f"{name}.bias", np.zeros(w.shape[0])).astype(np.float32),
                }
                if f"sincnet.norm1d.{i}.weight" in sd:
                    conv_p["norm"] = {
                        "scale": sd[f"sincnet.norm1d.{i}.weight"].astype(np.float32),
                        "bias": sd[f"sincnet.norm1d.{i}.bias"].astype(np.float32)}
                params["conv"].append(conv_p)
                break
        else:
            raise KeyError(f"sincnet conv layer {i} not found")
    for i in range(cfg.lstm_layers):
        params["lstm_fwd"].append(_lstm_layer(sd, i, False))
        params["lstm_bwd"].append(_lstm_layer(sd, i, True))
    for i in range(cfg.linear_layers):
        params["linear"].append({
            "kernel": np.ascontiguousarray(sd[f"linear.{i}.weight"].T).astype(np.float32),
            "bias": sd[f"linear.{i}.bias"].astype(np.float32),
        })
    params["classifier"] = {
        "kernel": np.ascontiguousarray(sd["classifier.weight"].T).astype(np.float32),
        "bias": sd["classifier.bias"].astype(np.float32),
    }
    return params
