"""NeMo Parakeet-TDT checkpoint → param-tree conversion.

Loads either a directory of safetensors or a ``.nemo`` archive (tar with
``model_weights.ckpt``; torch CPU is used only for deserialization). Key
names follow the NeMo FastConformer-TDT layout; batch-norm in the conv
modules is folded to scale/shift for inference.
"""

from __future__ import annotations

import tarfile
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .config import CONFIG_06B, ParakeetConfig


def _load_state_dict(model_dir: Path) -> Dict[str, np.ndarray]:
    st_files = sorted(Path(model_dir).glob("*.safetensors"))
    if st_files:
        from ...core.weights import load_safetensors

        return load_safetensors(model_dir)
    nemo_files = sorted(Path(model_dir).glob("*.nemo"))
    if not nemo_files:
        raise FileNotFoundError(f"no .safetensors or .nemo in {model_dir}")
    import torch

    with tarfile.open(nemo_files[0]) as tar:
        member = next(m for m in tar.getmembers() if m.name.endswith("model_weights.ckpt"))
        with tempfile.TemporaryDirectory() as td:
            tar.extract(member, td, filter="data")
            sd = torch.load(str(Path(td) / member.name), map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def _lin(sd, name, dtype=np.float32, bias=True) -> dict:
    p = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T).astype(dtype)}
    if bias and f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"].astype(dtype)
    return p


def _ln(sd, name, dtype=np.float32) -> dict:
    return {"weight": sd[f"{name}.weight"].astype(dtype), "bias": sd[f"{name}.bias"].astype(dtype)}


def _pw(sd, name) -> dict:
    """Pointwise conv1d [out, in, 1] → linear {kernel [in, out], bias?}."""
    p = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"][:, :, 0].T).astype(np.float32)}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"].astype(np.float32)
    return p


def convert_encoder(sd: Dict[str, np.ndarray], cfg: ParakeetConfig) -> dict:
    e = "encoder"

    def conv2d_w(name):  # torch OIHW → HWIO
        p = {"kernel": np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0)).astype(np.float32)}
        if f"{name}.bias" in sd:
            p["bias"] = sd[f"{name}.bias"].astype(np.float32)
        return p

    def dw2d_w(name):  # torch depthwise [C,1,3,3] → HWIO [3,3,1,C]
        p = {"kernel": np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0)).astype(np.float32)}
        p["bias"] = sd.get(f"{name}.bias", np.zeros(sd[f"{name}.weight"].shape[0])).astype(np.float32)
        return p

    def sub_out_lin(name):
        # NeMo flattens the subsampled map channel-major ([B,T,C,F] →
        # [B,T,C·F]); our encoder flattens freq-major ([B,T,F,C] → F·C),
        # so reorder the Linear's input columns accordingly.
        w = sd[f"{name}.weight"]                    # [d, C*F]
        c = sd[f"{e}.pre_encode.conv.0.weight"].shape[0]
        d_out, cf = w.shape
        f = cf // c
        w = w.reshape(d_out, c, f).transpose(0, 2, 1).reshape(d_out, cf)
        p = {"kernel": np.ascontiguousarray(w.T).astype(np.float32)}
        if f"{name}.bias" in sd:
            p["bias"] = sd[f"{name}.bias"].astype(np.float32)
        return p

    params = {
        "sub_conv1": conv2d_w(f"{e}.pre_encode.conv.0"),
        "sub_dw2": dw2d_w(f"{e}.pre_encode.conv.2"),
        "sub_pw2": conv2d_w(f"{e}.pre_encode.conv.3"),
        "sub_dw3": dw2d_w(f"{e}.pre_encode.conv.5"),
        "sub_pw3": conv2d_w(f"{e}.pre_encode.conv.6"),
        "sub_out": sub_out_lin(f"{e}.pre_encode.out"),
        # NeMo carries per-layer pos biases; these top-level copies are a
        # fallback for layers missing their own (never the case in practice).
        "pos_u": sd[f"{e}.layers.0.self_attn.pos_bias_u"].astype(np.float32),
        "pos_v": sd[f"{e}.layers.0.self_attn.pos_bias_v"].astype(np.float32),
        "layers": [],
    }
    # NOTE: NeMo has per-layer pos_bias; we keep layer 0's at the top for
    # API symmetry but use per-layer values below.
    for i in range(cfg.encoder_layers):
        l = f"{e}.layers.{i}"
        bn_w = sd[f"{l}.conv.batch_norm.weight"]
        bn_b = sd[f"{l}.conv.batch_norm.bias"]
        bn_m = sd[f"{l}.conv.batch_norm.running_mean"]
        bn_v = sd[f"{l}.conv.batch_norm.running_var"]
        scale = bn_w / np.sqrt(bn_v + 1e-5)
        shift = bn_b - bn_m * scale

        params["layers"].append(
            {
                "ff1": {"ln": _ln(sd, f"{l}.norm_feed_forward1"),
                        "w1": _lin(sd, f"{l}.feed_forward1.linear1"),
                        "w2": _lin(sd, f"{l}.feed_forward1.linear2")},
                "ff2": {"ln": _ln(sd, f"{l}.norm_feed_forward2"),
                        "w1": _lin(sd, f"{l}.feed_forward2.linear1"),
                        "w2": _lin(sd, f"{l}.feed_forward2.linear2")},
                "attn": {
                    "ln": _ln(sd, f"{l}.norm_self_att"),
                    "q": _lin(sd, f"{l}.self_attn.linear_q"),
                    "k": _lin(sd, f"{l}.self_attn.linear_k"),
                    "v": _lin(sd, f"{l}.self_attn.linear_v"),
                    "o": _lin(sd, f"{l}.self_attn.linear_out"),
                    "pos": _lin(sd, f"{l}.self_attn.linear_pos", bias=False),
                    "pos_u": sd[f"{l}.self_attn.pos_bias_u"].astype(np.float32),
                    "pos_v": sd[f"{l}.self_attn.pos_bias_v"].astype(np.float32),
                },
                "conv": {
                    "ln": _ln(sd, f"{l}.norm_conv"),
                    # pointwise conv1d [out, in, 1] → kernel [in, out];
                    # checkpoints shipping conv biases keep them (dropping
                    # them offsets every layer's conv-module activations)
                    "pw1": _pw(sd, f"{l}.conv.pointwise_conv1"),
                    "dw": {"kernel": np.transpose(sd[f"{l}.conv.depthwise_conv.weight"], (2, 1, 0)).astype(np.float32),
                           "bias": sd.get(f"{l}.conv.depthwise_conv.bias",
                                          np.zeros(sd[f"{l}.conv.depthwise_conv.weight"].shape[0])).astype(np.float32)},
                    "norm_scale": scale.astype(np.float32),
                    "norm_bias": shift.astype(np.float32),
                    "pw2": _pw(sd, f"{l}.conv.pointwise_conv2"),
                },
                "ln_out": _ln(sd, f"{l}.norm_out"),
            }
        )
    return params


def convert_decoder(sd: Dict[str, np.ndarray], cfg: ParakeetConfig) -> dict:
    d = cfg.decoder_hidden
    embed_w = sd["decoder.prediction.embed.weight"].astype(np.float32)
    if embed_w.shape[0] == cfg.vocab_size:  # blank row missing → zeros
        embed_w = np.concatenate([embed_w, np.zeros((1, embed_w.shape[1]), np.float32)])

    lstm = []
    for li in range(cfg.decoder_layers):
        wi = sd[f"decoder.prediction.dec_rnn.lstm.weight_ih_l{li}"]  # [4d, in]
        wh = sd[f"decoder.prediction.dec_rnn.lstm.weight_hh_l{li}"]
        bi = sd.get(f"decoder.prediction.dec_rnn.lstm.bias_ih_l{li}", np.zeros(4 * d))
        bh = sd.get(f"decoder.prediction.dec_rnn.lstm.bias_hh_l{li}", np.zeros(4 * d))
        lstm.append({
            "wx": np.ascontiguousarray(wi.T).astype(np.float32),
            "wh": np.ascontiguousarray(wh.T).astype(np.float32),
            "bias": (bi + bh).astype(np.float32),
        })

    def find_lin(prefixes):
        for p in prefixes:
            if f"{p}.weight" in sd:
                return _lin(sd, p)
        raise KeyError(f"none of {prefixes} in checkpoint")

    return {
        "embed": embed_w,
        "lstm": lstm,
        "joint_enc": find_lin(["joint.enc", "joint.joint_net.enc"]),
        "joint_pred": find_lin(["joint.pred", "joint.joint_net.pred"]),
        "joint_out": find_lin(["joint.joint_net.2", "joint.joint_net.3", "joint.out"]),
    }


def load_parakeet_checkpoint(model_dir, cfg: Optional[ParakeetConfig] = None):
    cfg = cfg or CONFIG_06B
    sd = _load_state_dict(Path(model_dir))
    enc = convert_encoder(sd, cfg)
    dec = convert_decoder(sd, cfg)
    tokenizer = None
    spm = sorted(Path(model_dir).glob("*.model"))
    if spm:
        from ...tokenizers.sentencepiece_model import SentencePieceModel

        tokenizer = SentencePieceModel.load(spm[0])
    return cfg, enc, dec, tokenizer
