"""FastConformer encoder (NeMo-style) — port of
``qwen3_asr_swift_tpu/models/parakeet/encoder.py``.

- dw_striding 8× subsampling: conv2d(1→C,3,s2) → [depthwise(3,s2) →
  pointwise] ×2, ReLU between, then Linear(C·mel/8 → d_model); the
  depthwise convs are ``ops/nn.py::depthwise_conv2d`` (fp32 tap sums, no
  cuDNN TF32);
- conformer blocks: ½FF(swish) → rel-pos MHSA (Transformer-XL u/v biases
  + the reference's pad-and-reshape relative shift, fp32 scores) → conv
  module (pointwise→GLU→masked depthwise(k9)→folded batch norm→swish→
  pointwise) → ½FF → LayerNorm.

Valid frame lengths are threaded as a mask. Sortformer reuses
:func:`encode`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import _linear, _norm, _normal
from ...ops.attention import NEG_INF
from ...ops.nn import conv1d, conv2d, depthwise_conv2d, layer_norm, linear
from .config import ParakeetConfig


def swish(x):
    return F.silu(x)


def subsampled_length(n_frames):
    """Valid frames after three stride-2 convs (k=3, p=1):
    L → (L-1)//2 + 1, applied three times (ints or integer tensors)."""
    l = n_frames
    for _ in range(3):
        l = (l - 1) // 2 + 1
    return l


# ---------------------------------------------------------------------------
# random parameters (the reference's tree, drawn with numpy or on a card)
# ---------------------------------------------------------------------------

def init_encoder_params(rng, cfg: ParakeetConfig) -> dict:
    """The reference's ``init_encoder_params`` tree: fp32 numpy from a numpy
    generator, or the kernels on a ``torch.Generator``'s device."""
    c = cfg.subsampling_channels
    d = cfg.encoder_hidden
    f_sub = subsampled_length(cfg.num_mel_bins)  # mel axis also /8

    def conv(kh, kw, cin, cout):
        return {"kernel": _normal(rng, (kh, kw, cin, cout), 1.0 / np.sqrt(kh * kw * cin)),
                "bias": np.zeros((cout,), np.float32)}

    def dw(ch):
        return {"kernel": _normal(rng, (3, 3, 1, ch), 1.0 / np.sqrt(9)),
                "bias": np.zeros((ch,), np.float32)}

    params = {
        "sub_conv1": conv(3, 3, 1, c),
        "sub_dw2": dw(c),
        "sub_pw2": conv(1, 1, c, c),
        "sub_dw3": dw(c),
        "sub_pw3": conv(1, 1, c, c),
        "sub_out": _linear(rng, c * f_sub, d),
        "pos_u": np.zeros((cfg.num_heads, cfg.head_dim), np.float32),
        "pos_v": np.zeros((cfg.num_heads, cfg.head_dim), np.float32),
        "layers": [],
    }
    dff = d * cfg.ffn_expansion
    for _ in range(cfg.encoder_layers):
        params["layers"].append({
            "ff1": {"ln": _norm(d, True), "w1": _linear(rng, d, dff),
                    "w2": _linear(rng, dff, d)},
            "ff2": {"ln": _norm(d, True), "w1": _linear(rng, d, dff),
                    "w2": _linear(rng, dff, d)},
            "attn": {"ln": _norm(d, True),
                     "q": _linear(rng, d, d), "k": _linear(rng, d, d),
                     "v": _linear(rng, d, d), "o": _linear(rng, d, d),
                     "pos": _linear(rng, d, d, bias=False)},
            "conv": {"ln": _norm(d, True),
                     "pw1": _linear(rng, d, 2 * d),
                     "dw": {"kernel": _normal(rng, (cfg.conv_kernel, 1, d), 0.1),
                            "bias": np.zeros((d,), np.float32)},
                     "norm_scale": np.ones((d,), np.float32),
                     "norm_bias": np.zeros((d,), np.float32),
                     "pw2": _linear(rng, d, d)},
            "ln_out": _norm(d, True),
        })
    return params


# ---------------------------------------------------------------------------
# relative positional attention
# ---------------------------------------------------------------------------

def rel_pos_encoding(t: int, d_model: int) -> np.ndarray:
    """Sinusoidal embeddings for relative positions T-1 … -(T-1)
    ([2T-1, d_model], NeMo RelPositionalEncoding layout)."""
    positions = np.arange(t - 1, -t, -1, dtype=np.float64)  # [2T-1]
    inv = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model))
    ang = positions[:, None] * inv[None, :]
    pe = np.zeros((len(positions), d_model))
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _rel_pos_table(t: int, d_model: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(rel_pos_encoding(t, d_model)).to(device)


def _rel_shift(x):
    """[B, H, T, 2T-1] → [B, H, T, T]: row i keeps columns aligned so that
    entry j corresponds to relative offset (j - i)."""
    b, h, t, l = x.shape
    x = F.pad(x, (1, 0))                                        # [B,H,T,2T]
    x = x.reshape(b, h, l + 1, t)
    x = x[:, :, 1:, :].reshape(b, h, t, l)
    return x[..., :t]


def rel_attention(p, x, pos_u, pos_v, mask, cfg: ParakeetConfig):
    """x: [B, T, d]; mask: [B, 1, 1, T] additive key mask. Scores, softmax
    and the value product in fp32."""
    b, t, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = linear(x, p["q"]).reshape(b, t, h, hd)
    k = linear(x, p["k"]).reshape(b, t, h, hd).transpose(1, 2)
    v = linear(x, p["v"]).reshape(b, t, h, hd).transpose(1, 2)

    pe = _rel_pos_table(t, d, x.device).to(x.dtype)             # [2T-1, d]
    pos = linear(pe, p["pos"]).reshape(2 * t - 1, h, hd).transpose(0, 1)  # [H, 2T-1, hd]

    q_u = (q + pos_u).transpose(1, 2)                           # [B,H,T,hd]
    q_v = (q + pos_v).transpose(1, 2)

    ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    bd = torch.matmul(q_v.float(), pos.float().transpose(-1, -2))  # [B,H,T,2T-1]
    scores = (ac + _rel_shift(bd)) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, v.float())
    out = out.transpose(1, 2).reshape(b, t, d).to(x.dtype)
    return linear(out, p["o"])


# ---------------------------------------------------------------------------
# conformer block + encoder
# ---------------------------------------------------------------------------

def _feed_forward(p, x, eps=1e-5):
    h = layer_norm(x, p["ln"]["weight"], p["ln"]["bias"], eps)
    return linear(swish(linear(h, p["w1"])), p["w2"])


def _conv_module(p, x, valid, cfg: ParakeetConfig):
    h = layer_norm(x, p["ln"]["weight"], p["ln"]["bias"], 1e-5)
    h = linear(h, p["pw1"])                                     # [B,T,2d]
    a, g = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(g)                                    # GLU
    h = torch.where(valid[..., None], h, h.new_zeros(()))       # keep padding out of the conv
    pad = (cfg.conv_kernel - 1) // 2
    h = conv1d(h, p["dw"], padding=pad, groups=h.shape[-1])
    h = h * p["norm_scale"] + p["norm_bias"]                    # folded batch norm
    h = swish(h)
    return linear(h, p["pw2"])


def subsample(params, mel):
    """dw_striding: conv → relu → (dw → pw → relu) ×2, then the linear:
    mel [B, T, n_mels] → [B, T/8, d]."""
    x = mel[..., None]            # [B, T(mel-time), n_mels, 1] — NHWC with H=time, W=mel
    same, none = ((1, 1), (1, 1)), ((0, 0), (0, 0))
    x = torch.relu(conv2d(x, params["sub_conv1"], stride=(2, 2), padding=same))
    x = depthwise_conv2d(x, params["sub_dw2"], stride=(2, 2), padding=same)
    x = torch.relu(conv2d(x, params["sub_pw2"], stride=(1, 1), padding=none))
    x = depthwise_conv2d(x, params["sub_dw3"], stride=(2, 2), padding=same)
    x = torch.relu(conv2d(x, params["sub_pw3"], stride=(1, 1), padding=none))
    bb, tt, ff, cc = x.shape                                    # [B, T/8, mel/8, C]
    return linear(x.reshape(bb, tt, ff * cc), params["sub_out"])


def encode(params, mel, n_valid_frames, cfg: ParakeetConfig):
    """mel: [B, T, n_mels] normalized log-mel; n_valid_frames: [B] int
    tensor. Returns (encoded [B, T/8, d] zero past the valid frames,
    n_valid_out [B])."""
    x = subsample(params, mel)
    tt = x.shape[1]
    n_out = subsampled_length(n_valid_frames)
    valid = torch.arange(tt, device=x.device)[None, :] < n_out[:, None]   # [B, T/8]
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]

    for lp in params["layers"]:
        x = x + 0.5 * _feed_forward(lp["ff1"], x)
        h = layer_norm(x, lp["attn"]["ln"]["weight"], lp["attn"]["ln"]["bias"], 1e-5)
        pos_u = lp["attn"].get("pos_u", params["pos_u"])
        pos_v = lp["attn"].get("pos_v", params["pos_v"])
        x = x + rel_attention(lp["attn"], h, pos_u, pos_v, mask, cfg)
        x = x + _conv_module(lp["conv"], x, valid, cfg)
        x = x + 0.5 * _feed_forward(lp["ff2"], x)
        x = layer_norm(x, lp["ln_out"]["weight"], lp["ln_out"]["bias"], 1e-5)

    x = torch.where(valid[..., None], x, x.new_zeros(()))
    return x, n_out
