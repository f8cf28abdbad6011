"""NeMo cache-aware streaming conformer checkpoint → param-tree conversion.

The reference consumes these models as opaque CoreML artifacts
(reference: Sources/ParakeetStreamingASR/ParakeetStreamingASR.swift:12-150
loads encoder/decoder/joint .mlmodelc units); here the NeMo state dict
(.nemo tar or safetensors directory) is mapped directly onto the
streaming tree in :mod:`.encoder` / :mod:`.model`. Batch norm inside the
conformer conv module folds to an affine scale/shift (inference only).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import StreamingConformerConfig


def _lin(sd, name, dtype=np.float32, bias=True) -> dict:
    p = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T).astype(dtype)}
    if bias and f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"].astype(dtype)
    return p


def _ln(sd, name, dtype=np.float32) -> dict:
    return {"weight": sd[f"{name}.weight"].astype(dtype),
            "bias": sd[f"{name}.bias"].astype(dtype)}


def _pwconv(sd, name) -> dict:
    """Pointwise conv1d [out, in, 1] → linear {kernel [in, out], bias?}."""
    p = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"][:, :, 0].T).astype(np.float32)}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"].astype(np.float32)
    return p


def convert_streaming_encoder(sd: Dict[str, np.ndarray],
                              cfg: StreamingConformerConfig) -> dict:
    e = "encoder"

    def conv1d_w(name):  # torch [out, in, k] → [k, in, out]
        p = {"kernel": np.transpose(sd[f"{name}.weight"], (2, 1, 0)).astype(np.float32)}
        if f"{name}.bias" in sd:
            p["bias"] = sd[f"{name}.bias"].astype(np.float32)
        return p

    params = {
        "sub1": conv1d_w(f"{e}.pre_encode.conv.0"),
        "sub2": conv1d_w(f"{e}.pre_encode.conv.2"),
        "sub3": conv1d_w(f"{e}.pre_encode.conv.4"),
        "sub_out": _lin(sd, f"{e}.pre_encode.out"),
        "pos_u": sd[f"{e}.layers.0.self_attn.pos_bias_u"].astype(np.float32),
        "pos_v": sd[f"{e}.layers.0.self_attn.pos_bias_v"].astype(np.float32),
        "layers": [],
    }
    for i in range(cfg.encoder_layers):
        l = f"{e}.layers.{i}"
        bn_w = sd[f"{l}.conv.batch_norm.weight"]
        bn_b = sd[f"{l}.conv.batch_norm.bias"]
        bn_m = sd[f"{l}.conv.batch_norm.running_mean"]
        bn_v = sd[f"{l}.conv.batch_norm.running_var"]
        scale = (bn_w / np.sqrt(bn_v + 1e-5)).astype(np.float32)
        shift = (bn_b - bn_m * scale).astype(np.float32)
        params["layers"].append({
            "ff1_ln": _ln(sd, f"{l}.norm_feed_forward1"),
            "ff1_in": _lin(sd, f"{l}.feed_forward1.linear1"),
            "ff1_out": _lin(sd, f"{l}.feed_forward1.linear2"),
            "att_ln": _ln(sd, f"{l}.norm_self_att"),
            "att": {
                "q": _lin(sd, f"{l}.self_attn.linear_q"),
                "k": _lin(sd, f"{l}.self_attn.linear_k"),
                "v": _lin(sd, f"{l}.self_attn.linear_v"),
                "o": _lin(sd, f"{l}.self_attn.linear_out"),
                "pos": _lin(sd, f"{l}.self_attn.linear_pos", bias=False),
                # per-layer Transformer-XL biases (NeMo carries one pair per
                # layer; the top-level copy is only a fallback)
                "pos_u": sd[f"{l}.self_attn.pos_bias_u"].astype(np.float32),
                "pos_v": sd[f"{l}.self_attn.pos_bias_v"].astype(np.float32),
            },
            "conv_ln": _ln(sd, f"{l}.norm_conv"),
            "conv": {
                # checkpoints shipping conv biases keep them (dropping them
                # offsets every layer's conv-module activations)
                "pw1": _pwconv(sd, f"{l}.conv.pointwise_conv1"),
                "dw": {"kernel": np.transpose(
                    sd[f"{l}.conv.depthwise_conv.weight"], (2, 1, 0)).astype(np.float32),
                    "bias": sd.get(f"{l}.conv.depthwise_conv.bias",
                                   np.zeros(cfg.encoder_hidden)).astype(np.float32)},
                "norm": {"weight": scale, "bias": shift},
                "pw2": _pwconv(sd, f"{l}.conv.pointwise_conv2"),
            },
            "ff2_ln": _ln(sd, f"{l}.norm_feed_forward2"),
            "ff2_in": _lin(sd, f"{l}.feed_forward2.linear1"),
            "ff2_out": _lin(sd, f"{l}.feed_forward2.linear2"),
            "final_ln": _ln(sd, f"{l}.norm_out"),
        })
    return params


def convert_streaming_decoder(sd: Dict[str, np.ndarray],
                              cfg: StreamingConformerConfig) -> dict:
    """Prediction-net LSTM + joint. NeMo names: decoder.prediction.embed,
    decoder.prediction.dec_rnn.lstm, joint.enc/joint.pred/joint.joint_net."""
    lstm_layers = []
    for i in range(cfg.decoder_layers):
        base = f"decoder.prediction.dec_rnn.lstm"
        wx = sd[f"{base}.weight_ih_l{i}"]  # [4h, in]
        wh = sd[f"{base}.weight_hh_l{i}"]  # [4h, h]
        b = sd.get(f"{base}.bias_ih_l{i}", 0) + sd.get(f"{base}.bias_hh_l{i}", 0)
        lstm_layers.append({
            "wx": np.ascontiguousarray(wx.T).astype(np.float32),
            "wh": np.ascontiguousarray(wh.T).astype(np.float32),
            "bias": np.asarray(b, np.float32).reshape(-1),
        })
    return {
        "embed": sd["decoder.prediction.embed.weight"].astype(np.float32),
        "lstm": lstm_layers,
        "joint_enc": _lin(sd, "joint.enc"),
        "joint_pred": _lin(sd, "joint.pred"),
        "joint_out": _lin(sd, "joint.joint_net.2"),
    }


def convert_streaming_checkpoint(model_dir, cfg: StreamingConformerConfig) -> Tuple[dict, dict]:
    from ..parakeet.convert import _load_state_dict

    sd = _load_state_dict(Path(model_dir))
    return convert_streaming_encoder(sd, cfg), convert_streaming_decoder(sd, cfg)


def load_vocabulary(model_dir) -> Optional[List[str]]:
    """vocab.txt (one SentencePiece piece per line) or tokenizer.model."""
    model_dir = Path(model_dir)
    txt = model_dir / "vocab.txt"
    if txt.exists():
        return [line.rstrip("\n") for line in txt.open(encoding="utf-8")]
    spm = model_dir / "tokenizer.model"
    if spm.exists():
        from ...tokenizers.sentencepiece_model import SentencePieceModel

        return [p for p, _, _ in SentencePieceModel.load(spm).pieces]
    return None
