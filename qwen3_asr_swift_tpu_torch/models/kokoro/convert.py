"""Kokoro-82M checkpoint conversion (hexgrad kokoro-v1_0.pth layout).

The published checkpoint is a dict of five module state-dicts — ``bert``
(transformers ALBERT), ``bert_encoder`` (Linear 768→512), ``predictor``
(StyleTTS2 ProsodyPredictor), ``text_encoder``, ``decoder`` (StyleTTS2
iSTFTNet) — each possibly ``module.``-prefixed (DataParallel training).
Voice packs are ``voices/*.pt`` tensors [510, 1, 256].

Layout fixes done once here: torch Linear [out,in] → kernel [in,out];
Conv1d [out,in,k] → [k,in,out]; ConvTranspose1d [in,out,k] → [k,in,out];
weight-norm (g,v) pairs fused; LSTM gate matrices transposed and the two
bias vectors summed; depthwise-pool ConvTranspose taps flipped (model.py
runs it as an lhs-dilated conv).

The reference consumes these same weights via its precompiled CoreML blob
(Sources/KokoroTTS/KokoroModel.swift); this converter makes
``from_pretrained`` load the real thing directly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .model import CONFIG_82M, KokoroConfig


from ...core.weights import fuse_weight_norm as _fuse_weight_norm  # noqa: E402


def _strip_module(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def _lin(sd, name):
    p = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T).astype(np.float32)}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"].astype(np.float32)
    return p


def _ln(sd, name, weight="weight", bias="bias"):
    return {"weight": sd[f"{name}.{weight}"].astype(np.float32),
            "bias": sd[f"{name}.{bias}"].astype(np.float32)}


def _conv(sd, name, bias=True):
    p = {"kernel": np.ascontiguousarray(
        np.transpose(sd[f"{name}.weight"], (2, 1, 0))).astype(np.float32)}
    if bias and f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"].astype(np.float32)
    return p


def _convt(sd, name):
    """torch ConvTranspose1d [in, out, k] → taps flipped → [k, in, out]
    (model.py runs jax.lax.conv_transpose with transpose_kernel=False,
    which cross-correlates the dilated input — the flip restores torch's
    transposed-conv semantics; verified in tests/test_kokoro.py)."""
    p = {"kernel": np.ascontiguousarray(
        np.transpose(sd[f"{name}.weight"][:, :, ::-1], (2, 0, 1))).astype(np.float32)}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"].astype(np.float32)
    return p


def _lstm_dir(sd, name, suffix=""):
    return {
        "wx": np.ascontiguousarray(sd[f"{name}.weight_ih_l0{suffix}"].T).astype(np.float32),
        "wh": np.ascontiguousarray(sd[f"{name}.weight_hh_l0{suffix}"].T).astype(np.float32),
        "bias": (sd[f"{name}.bias_ih_l0{suffix}"]
                 + sd[f"{name}.bias_hh_l0{suffix}"]).astype(np.float32),
    }


def _bilstm(sd, name):
    return {"fwd": _lstm_dir(sd, name), "bwd": _lstm_dir(sd, name, "_reverse")}


def _adain(sd, name):
    return {"fc": _lin(sd, f"{name}.fc")}


def _adain_resblk(sd, name, upsample=False):
    p = {
        "norm1": _adain(sd, f"{name}.norm1"),
        "conv1": _conv(sd, f"{name}.conv1"),
        "norm2": _adain(sd, f"{name}.norm2"),
        "conv2": _conv(sd, f"{name}.conv2"),
    }
    if f"{name}.conv1x1.weight" in sd:
        p["conv1x1"] = _conv(sd, f"{name}.conv1x1", bias=False)
    if upsample and f"{name}.pool.weight" in sd:
        # depthwise ConvTranspose1d [cin, 1, k] → taps flipped → [k, 1, cin]
        w = sd[f"{name}.pool.weight"][:, :, ::-1]
        p["pool"] = {"kernel": np.ascontiguousarray(np.transpose(w, (2, 1, 0))).astype(np.float32),
                     "bias": sd[f"{name}.pool.bias"].astype(np.float32)}
    return p


def _adain_resblock1(sd, name, n_dil):
    p = {"convs1": [], "convs2": [], "adain1": [], "adain2": [], "alpha1": [], "alpha2": []}
    for j in range(n_dil):
        p["convs1"].append(_conv(sd, f"{name}.convs1.{j}"))
        p["convs2"].append(_conv(sd, f"{name}.convs2.{j}"))
        p["adain1"].append(_adain(sd, f"{name}.adain1.{j}"))
        p["adain2"].append(_adain(sd, f"{name}.adain2.{j}"))
        p["alpha1"].append(sd[f"{name}.alpha1.{j}"].reshape(-1).astype(np.float32))
        p["alpha2"].append(sd[f"{name}.alpha2.{j}"].reshape(-1).astype(np.float32))
    return p


def convert_albert(sd: Dict[str, np.ndarray]) -> dict:
    base = "encoder.albert_layer_groups.0.albert_layers.0"
    return {
        "word_embeddings": sd["embeddings.word_embeddings.weight"].astype(np.float32),
        "position_embeddings": sd["embeddings.position_embeddings.weight"].astype(np.float32),
        "token_type_embeddings": sd["embeddings.token_type_embeddings.weight"].astype(np.float32),
        "embed_ln": _ln(sd, "embeddings.LayerNorm"),
        "embed_proj": _lin(sd, "encoder.embedding_hidden_mapping_in"),
        "q": _lin(sd, f"{base}.attention.query"),
        "k": _lin(sd, f"{base}.attention.key"),
        "v": _lin(sd, f"{base}.attention.value"),
        "attn_out": _lin(sd, f"{base}.attention.dense"),
        "attn_ln": _ln(sd, f"{base}.attention.LayerNorm"),
        "ffn": _lin(sd, f"{base}.ffn"),
        "ffn_out": _lin(sd, f"{base}.ffn_output"),
        "full_ln": _ln(sd, f"{base}.full_layer_layer_norm"),
    }


def convert_predictor(sd: Dict[str, np.ndarray], cfg: KokoroConfig) -> dict:
    dur_encoder = []
    for i in range(cfg.n_dur_layers):
        dur_encoder.append({
            "lstm": _bilstm(sd, f"text_encoder.lstms.{2 * i}"),
            "ada_ln": {"fc": _lin(sd, f"text_encoder.lstms.{2 * i + 1}.fc")},
        })
    return {
        "dur_encoder": dur_encoder,
        "lstm": _bilstm(sd, "lstm"),
        "duration_proj": _lin(sd, "duration_proj.linear_layer"),
        "shared": _bilstm(sd, "shared"),
        "F0": [_adain_resblk(sd, "F0.0"), _adain_resblk(sd, "F0.1", upsample=True),
               _adain_resblk(sd, "F0.2")],
        "F0_proj": _conv(sd, "F0_proj"),
        "N": [_adain_resblk(sd, "N.0"), _adain_resblk(sd, "N.1", upsample=True),
              _adain_resblk(sd, "N.2")],
        "N_proj": _conv(sd, "N_proj"),
    }


def convert_text_encoder(sd: Dict[str, np.ndarray]) -> dict:
    cnn = []
    i = 0
    while f"cnn.{i}.0.weight" in sd:
        cnn.append({
            "conv": _conv(sd, f"cnn.{i}.0"),
            "ln": _ln(sd, f"cnn.{i}.1", weight="gamma", bias="beta"),
        })
        i += 1
    return {
        "embedding": sd["embedding.weight"].astype(np.float32),
        "cnn": cnn,
        "lstm": _bilstm(sd, "lstm"),
    }


def convert_decoder(sd: Dict[str, np.ndarray], cfg: KokoroConfig) -> dict:
    n_dil = len(cfg.resblock_dilations)
    n_up = len(cfg.upsample_rates)
    n_k = len(cfg.resblock_kernels)
    gen = {
        "m_source": _lin(sd, "generator.m_source.l_linear"),
        "noise_convs": [_conv(sd, f"generator.noise_convs.{i}") for i in range(n_up)],
        "noise_res": [_adain_resblock1(sd, f"generator.noise_res.{i}", n_dil)
                      for i in range(n_up)],
        "ups": [_convt(sd, f"generator.ups.{i}") for i in range(n_up)],
        "resblocks": [_adain_resblock1(sd, f"generator.resblocks.{i}", n_dil)
                      for i in range(n_up * n_k)],
        "conv_post": _conv(sd, "generator.conv_post"),
    }
    return {
        "F0_conv": _conv(sd, "F0_conv"),
        "N_conv": _conv(sd, "N_conv"),
        "encode": _adain_resblk(sd, "encode"),
        "decode": [_adain_resblk(sd, f"decode.{i}", upsample=(i == 3)) for i in range(4)],
        "asr_res": _conv(sd, "asr_res.0"),
        "generator": gen,
    }


def convert_checkpoint(model_dir: str | Path, cfg: KokoroConfig = CONFIG_82M) -> dict:
    """Convert kokoro-v1_0.pth (or per-module safetensors) into the
    canonical tree."""
    model_dir = Path(model_dir)
    pth = sorted(model_dir.glob("*.pth"))
    if pth:
        import torch

        raw = torch.load(str(pth[0]), map_location="cpu", weights_only=True)
        modules = {name: {k: v.float().numpy() for k, v in sd.items()}
                   for name, sd in raw.items()}
    else:
        from ...core.weights import load_safetensors

        flat = load_safetensors(model_dir)
        modules = {}
        for key, val in flat.items():
            mod, rest = key.split(".", 1)
            modules.setdefault(mod, {})[rest] = val
    modules = {name: _fuse_weight_norm(_strip_module(sd)) for name, sd in modules.items()}
    return {
        "bert": convert_albert(modules["bert"]),
        "bert_encoder": {"kernel": np.ascontiguousarray(
                             modules["bert_encoder"]["weight"].T).astype(np.float32),
                         "bias": modules["bert_encoder"]["bias"].astype(np.float32)},
        "text_encoder": convert_text_encoder(modules["text_encoder"]),
        "predictor": convert_predictor(modules["predictor"], cfg),
        "decoder": convert_decoder(modules["decoder"], cfg),
    }


def load_voices(model_dir: str | Path) -> Dict[str, np.ndarray]:
    """voices/*.pt → {name: [510, 256]} style tables (JSON single-vector
    voices also accepted, matching the reference's CoreML export layout)."""
    model_dir = Path(model_dir)
    out: Dict[str, np.ndarray] = {}
    vdir = model_dir / "voices"
    if not vdir.exists():
        return out
    for f in sorted(vdir.iterdir()):
        if f.suffix == ".pt":
            import torch

            t = torch.load(str(f), map_location="cpu", weights_only=True)
            out[f.stem] = np.asarray(t, np.float32).reshape(t.shape[0], -1)
        elif f.suffix == ".json":
            import json

            data = json.loads(f.read_text())
            emb = data.get("embedding")
            if emb:
                out[f.stem] = np.asarray(emb, np.float32)
    return out
