"""Cache-aware streaming conformer encoder — port of
``qwen3_asr_swift_tpu/models/parakeet_streaming/encoder.py``.

One chunk step (:func:`encode_chunk`): mel chunk + caches → encoder frames
+ advanced caches, every shape fixed, on the device.

Causality layout:
- subsampling: pre_cache (7 mel frames) ‖ chunk (8k frames) through three
  stride-2 k=3 VALID convs (receptive field 15, stride 8) → exactly k new
  frames; new pre_cache = last 7 mel frames.
- attention: keys/values are cache_channel (att_context tokens,
  right-aligned) ‖ current chunk; Transformer-XL u/v biases with a
  sinusoid relative-position table gathered per (query, key) offset.
- conv module: depthwise k=9 VALID over cache_time (8 tokens) ‖ chunk.
Cache updates shift left and append.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import _linear, _norm, _normal
from ...ops.attention import NEG_INF
from ...ops.nn import conv1d, layer_norm, linear, upcast
from ..parakeet.mel import _bases
from .config import StreamingConformerConfig


def swish(x):
    return F.silu(x)


@dataclasses.dataclass(frozen=True)
class EncoderCaches:
    """Streaming carry (reference: cacheLastChannel/Time/Len + preCache,
    StreamingSession.swift:20-24)."""

    pre_mel: torch.Tensor        # [B, pre_cache, mel]
    channel: torch.Tensor        # [L, B, att_context, D] cached attention keys input
    time: torch.Tensor           # [L, B, conv_cache, D] cached conv left context
    channel_len: torch.Tensor    # [B] int32 — valid entries in `channel`
    sample_tail: torch.Tensor    # [B, n_fft - hop] raw-sample left context for the
                                 # streaming mel


def init_caches(cfg: StreamingConformerConfig, batch: int = 1, dtype=torch.float32,
                device="cpu") -> EncoderCaches:
    zeros = functools.partial(torch.zeros, dtype=dtype, device=device)
    return EncoderCaches(
        pre_mel=zeros((batch, cfg.pre_cache, cfg.num_mel_bins)),
        channel=zeros((cfg.encoder_layers, batch, cfg.att_context, cfg.encoder_hidden)),
        time=zeros((cfg.encoder_layers, batch, cfg.conv_cache, cfg.encoder_hidden)),
        channel_len=torch.zeros((batch,), dtype=torch.int32, device=device),
        sample_tail=zeros((batch, cfg.n_fft - cfg.hop_length)),
    )


# ---------------------------------------------------------------------------
# random parameters (the reference's tree)
# ---------------------------------------------------------------------------

def init_encoder_params(rng, cfg: StreamingConformerConfig) -> dict:
    c = cfg.subsampling_channels
    d = cfg.encoder_hidden
    h, hd = cfg.num_heads, cfg.head_dim

    def conv1d_k3(cin, cout):
        return {"kernel": _normal(rng, (3, cin, cout), 1.0 / np.sqrt(3 * cin)),
                "bias": np.zeros((cout,), np.float32)}

    lin = functools.partial(_linear, rng)
    params = {
        "sub1": conv1d_k3(cfg.num_mel_bins, c),
        "sub2": conv1d_k3(c, c),
        "sub3": conv1d_k3(c, c),
        "sub_out": lin(c, d),
        "pos_u": np.zeros((h, hd), np.float32),
        "pos_v": np.zeros((h, hd), np.float32),
        "layers": [],
    }
    ffn_dim = d * cfg.ffn_expansion
    for _ in range(cfg.encoder_layers):
        params["layers"].append({
            "ff1_ln": _norm(d, True), "ff1_in": lin(d, ffn_dim), "ff1_out": lin(ffn_dim, d),
            "att_ln": _norm(d, True),
            "att": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                    "pos": lin(d, d, bias=False)},
            "conv_ln": _norm(d, True),
            "conv": {"pw1": lin(d, 2 * d),
                     "dw": {"kernel": _normal(rng, (cfg.conv_kernel, 1, d),
                                             1.0 / np.sqrt(cfg.conv_kernel)),
                            "bias": np.zeros((d,), np.float32)},
                     "norm": _norm(d, True),
                     "pw2": lin(d, d)},
            "ff2_ln": _norm(d, True), "ff2_in": lin(d, ffn_dim), "ff2_out": lin(ffn_dim, d),
            "final_ln": _norm(d, True),
        })
    return params


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def _subsample(params, cfg: StreamingConformerConfig, pre_mel, mel_chunk):
    """pre_mel [B,P,mel] ‖ chunk [B,M,mel] → ([B, M/8, D], new pre_mel).

    Three k=3 s=2 VALID 1-d convs over time (features as channels, fp32
    tap sums): with P = 7 the output length is exactly M/8 and each output
    frame sees only current + past mel frames."""
    x = torch.cat([pre_mel, mel_chunk], dim=1)                  # [B, P+M, mel]
    new_pre = x[:, -cfg.pre_cache:]
    for name in ("sub1", "sub2", "sub3"):
        x = torch.relu(conv1d(x, params[name], stride=2))
    return linear(x, params["sub_out"]), new_pre


def _rel_table(max_dist: int, d_model: int) -> np.ndarray:
    """Sinusoid embeddings for relative offsets -max_dist..+max_dist
    (row r ↔ offset r - max_dist)."""
    pos = np.arange(-max_dist, max_dist + 1, dtype=np.float32)
    inv = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-np.log(10000.0) / d_model))
    table = np.zeros((2 * max_dist + 1, d_model), np.float32)
    table[:, 0::2] = np.sin(pos[:, None] * inv)
    table[:, 1::2] = np.cos(pos[:, None] * inv)
    return table


@functools.lru_cache(maxsize=16)
def _rel_constants(c: int, t: int, d_model: int, device: torch.device):
    """The offset table [2(C+T)-1, D] and the gather index [T·(C+T)] of
    (query i at C+i, key j) → row (C+i-j) + max, made once a device."""
    max_dist = c + t - 1
    rel_idx = (np.arange(t)[:, None] + c - np.arange(c + t)[None, :]) + max_dist
    with torch.inference_mode(False):
        return (torch.from_numpy(_rel_table(max_dist, d_model)).to(device),
                torch.from_numpy(rel_idx.reshape(-1)).to(device))


def _cached_attention(p, pos_u, pos_v, x, cache_k, cache_len, cfg: StreamingConformerConfig):
    """x [B,T,D] attends over cache_k [B,C,D] ‖ x. Returns [B,T,D].

    Transformer-XL scoring: (q+u)·k + (q+v)·pos_emb[rel], the offset table
    gathered explicitly; scores, softmax and the value product in fp32."""
    b, t, d = x.shape
    c = cfg.att_context
    h, hd = cfg.num_heads, cfg.head_dim
    kv_in = torch.cat([cache_k, x], dim=1)                      # [B, C+T, D]

    q = linear(x, p["q"]).reshape(b, t, h, hd)
    k = linear(kv_in, p["k"]).reshape(b, c + t, h, hd).transpose(1, 2)
    v = linear(kv_in, p["v"]).reshape(b, c + t, h, hd).transpose(1, 2)

    table, rel_idx = _rel_constants(c, t, d, x.device)
    pos = linear(table.to(x.dtype), p["pos"]).reshape(-1, h, hd)
    pos_qk = pos[rel_idx].reshape(t, c + t, h, hd)

    q_u = (q + pos_u).transpose(1, 2).float()
    q_v = (q + pos_v).float()
    ac = torch.matmul(q_u, k.float().transpose(-1, -2))
    bd = torch.einsum("bqhd,qkhd->bhqk", q_v, pos_qk.float())
    scores = (ac + bd) / math.sqrt(hd)

    # mask out unfilled cache slots (cache is right-aligned)
    slot = torch.arange(c + t, device=x.device)[None, :]
    valid = (slot >= (c - cache_len[:, None])) | (slot >= c)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, v.float())
    out = out.transpose(1, 2).reshape(b, t, d).to(x.dtype)
    return linear(out, p["o"])


def _cached_conv(p, x, cache_t, cfg: StreamingConformerConfig):
    """Conv module with carried left context. x [B,T,D], cache_t
    [B,K-1,D] (the previous GLU outputs). Returns ([B,T,D], new cache)."""
    a, b_ = linear(x, p["pw1"]).chunk(2, dim=-1)
    g = a * torch.sigmoid(b_)                                   # GLU [B,T,D]
    full = torch.cat([cache_t, g], dim=1)                       # [B, K-1+T, D]
    new_cache = full[:, -cfg.conv_cache:]
    y = upcast(conv1d(full, p["dw"], groups=cfg.encoder_hidden))
    # inference-folded batch norm: y*scale + shift
    y = (y * upcast(p["norm"]["weight"]) + upcast(p["norm"]["bias"])).to(x.dtype)
    return linear(swish(y), p["pw2"]), new_cache


def _ff(x, ln, fin, fout):
    h = layer_norm(x, ln["weight"], ln["bias"])
    return linear(swish(linear(h, fin)), fout)


# ---------------------------------------------------------------------------
# chunk step
# ---------------------------------------------------------------------------

def encode_chunk(params, cfg: StreamingConformerConfig, mel_chunk,
                 caches: EncoderCaches) -> Tuple[torch.Tensor, EncoderCaches]:
    """mel_chunk [B, mel_frames, mel] + caches → ([B, out_frames, D],
    advanced caches)."""
    x, new_pre = _subsample(params, cfg, caches.pre_mel, mel_chunk)
    t = x.shape[1]

    new_channel, new_time = [], []
    for li, p in enumerate(params["layers"]):
        x = x + 0.5 * _ff(x, p["ff1_ln"], p["ff1_in"], p["ff1_out"])

        att_in = layer_norm(x, p["att_ln"]["weight"], p["att_ln"]["bias"])
        # cache the *layer input* tokens as future left context
        cat = torch.cat([caches.channel[li], att_in], dim=1)
        new_channel.append(cat[:, -cfg.att_context:])
        pos_u = p["att"].get("pos_u", params["pos_u"])
        pos_v = p["att"].get("pos_v", params["pos_v"])
        x = x + _cached_attention(p["att"], pos_u, pos_v,
                                  att_in, caches.channel[li], caches.channel_len, cfg)

        conv_in = layer_norm(x, p["conv_ln"]["weight"], p["conv_ln"]["bias"])
        y, tc = _cached_conv(p["conv"], conv_in, caches.time[li], cfg)
        new_time.append(tc)
        x = x + y

        x = x + 0.5 * _ff(x, p["ff2_ln"], p["ff2_in"], p["ff2_out"])
        x = layer_norm(x, p["final_ln"]["weight"], p["final_ln"]["bias"])

    new_caches = EncoderCaches(
        pre_mel=new_pre,
        channel=torch.stack(new_channel),
        time=torch.stack(new_time),
        channel_len=torch.clamp(caches.channel_len + t, max=cfg.att_context),
        sample_tail=caches.sample_tail,  # advanced by streaming_log_mel
    )
    return x, new_caches


# ---------------------------------------------------------------------------
# streaming mel (causal, unnormalized — NeMo streaming models are trained
# with normalize: NA; reference: StreamingSession.swift:253-258)
# ---------------------------------------------------------------------------

def streaming_log_mel(chunk, sample_tail, cfg: StreamingConformerConfig):
    """chunk [B, mel_frames*hop] raw samples + carried tail [B, n_fft-hop]
    → (log-mel [B, mel_frames, n_mels], new tail). Fully causal: frame t
    covers samples [t*hop, t*hop + n_fft) of tail ‖ chunk."""
    x = torch.cat([sample_tail, chunk], dim=1)                  # [B, L]
    new_tail = x[:, -(cfg.n_fft - cfg.hop_length):]
    # pre-emphasis over the extended signal (first-ever sample uses x[0])
    y = torch.cat([x[:, :1], x[:, 1:] - cfg.pre_emphasis * x[:, :-1]], dim=1)
    dev = x.device
    idx = (torch.arange(cfg.mel_frames, device=dev)[:, None] * cfg.hop_length
           + torch.arange(cfg.n_fft, device=dev)[None, :])      # [F, n_fft]
    frames = y[:, idx]                                          # [B, F, n_fft]
    cos_m, sin_m, fb = _bases(cfg, dev)
    re, im = frames @ cos_m, frames @ sin_m
    power = re * re + im * im
    return torch.log(power @ fb + cfg.log_zero_guard), new_tail
