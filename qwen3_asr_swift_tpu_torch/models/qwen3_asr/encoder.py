"""Qwen3-ASR audio encoder — port of ``qwen3_asr_swift_tpu/models/qwen3_asr/encoder.py``,
batched over clips.

mel → conv2d×3 (stride 2) → channels-major flatten → conv_out →
+sinusoidal positions → layers of [pre-LN MHA → pre-LN GELU-FFN] with
attention inside 104-token windows (windows are the batch) → ln_post →
proj1 → GELU → proj2.

The convs run NCHW (the reference runs NHWC with HWIO kernels). The
flatten reproduces the reference's order exactly: its
``[nc, freq, tt, chans].transpose(0, 2, 3, 1)`` is the NCHW
``[nc, chans, freq, tt].permute(0, 3, 1, 2)``, both ``[nc, tt, chans, freq]``
before the reshape to ``chans*freq`` features.

The sequence-parallel ``sp_mesh`` branch of the reference is not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...ops.attention import NEG_INF, sdpa
from ...ops.nn import conv2d_nchw, gelu, layer_norm, linear
from .config import AudioEncoderConfig


@functools.lru_cache(maxsize=4)
def sinusoidal_positions(seq_len: int, d_model: int) -> np.ndarray:
    """[seq_len, d_model] — sin/cos concatenated (not interleaved)."""
    half = d_model // 2
    log_inc = np.log(10000.0) / (half - 1)
    inv = np.exp(-log_inc * np.arange(half, dtype=np.float64))
    scaled = np.arange(seq_len, dtype=np.float64)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _valid_tokens(n_valid_frames: torch.Tensor, cfg: AudioEncoderConfig) -> torch.Tensor:
    """mel-frame count → conv-token count (on device)."""
    chunk = cfg.chunk_frames
    full_chunks = torch.div(n_valid_frames, chunk, rounding_mode="floor")
    rem = n_valid_frames % chunk
    rem_tokens = torch.where(rem == 0, torch.zeros_like(rem), (((rem - 1) // 2) // 2) // 2 + 1)
    return full_chunks * cfg.tokens_per_chunk + torch.maximum(
        rem_tokens, (rem > 0).to(rem.dtype))


def _encoder_layer(p, x, mask, cfg: AudioEncoderConfig):
    """x [n_win, 104, d]; mask [n_win, 1, 1, 104] additive."""
    nw, t, d = x.shape
    h = layer_norm(x, p["attn_ln"]["weight"], p["attn_ln"]["bias"], cfg.layer_norm_eps)

    def heads(y):
        return y.reshape(nw, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)

    q, k, v = heads(linear(h, p["q_proj"])), heads(linear(h, p["k_proj"])), heads(linear(h, p["v_proj"]))
    attn = sdpa(q, k, v, scale=1.0 / np.sqrt(cfg.head_dim), mask=mask)
    x = x + linear(attn.transpose(1, 2).reshape(nw, t, d), p["out_proj"])
    h = layer_norm(x, p["final_ln"]["weight"], p["final_ln"]["bias"], cfg.layer_norm_eps)
    return x + linear(gelu(linear(h, p["fc1"])), p["fc2"])


def _encode_core(params, mel: torch.Tensor, n_valid_tokens: torch.Tensor,
                 cfg: AudioEncoderConfig) -> torch.Tensor:
    """mel [B, n_mels, T] → tokens [B, n_tokens, output_dim]."""
    b, n_mels, t_frames = mel.shape
    chunk = cfg.chunk_frames
    n_chunks = t_frames // chunk
    tpc = cfg.tokens_per_chunk

    # [B*n_chunks, 1, mel, 100] — chunks as the conv batch
    x = mel.reshape(b, n_mels, n_chunks, chunk).permute(0, 2, 1, 3)
    x = x.reshape(b * n_chunks, 1, n_mels, chunk)
    for name in ("conv1", "conv2", "conv3"):
        x = gelu(conv2d_nchw(x, params[name], stride=(2, 2), padding=(1, 1)))
    nc, chans, freq, tt = x.shape
    x = x.permute(0, 3, 1, 2).reshape(nc, tt, chans * freq)  # channels-major flatten
    x = linear(x, params["conv_out"])                          # [B*n_chunks, 13, d]
    pos = torch.from_numpy(sinusoidal_positions(tpc, cfg.d_model)).to(x.device, x.dtype)
    x = x + pos[None]

    n_tokens = n_chunks * tpc
    n_win = n_tokens // cfg.window_tokens
    x = x.reshape(b * n_win, cfg.window_tokens, cfg.d_model)
    token_ids = torch.arange(n_tokens, device=x.device).reshape(n_win, cfg.window_tokens)
    key_valid = token_ids[None] < n_valid_tokens.to(x.device)[:, None, None]  # [B, n_win, 104]
    mask = torch.where(key_valid, 0.0, NEG_INF).to(torch.float32)
    mask = mask.reshape(b * n_win, 1, 1, cfg.window_tokens)

    for layer_params in params["layers"]:
        x = _encoder_layer(layer_params, x, mask, cfg)

    x = x.reshape(b, n_tokens, cfg.d_model)
    x = layer_norm(x, params["ln_post"]["weight"], params["ln_post"]["bias"], cfg.layer_norm_eps)
    x = gelu(linear(x, params["proj1"]))
    return linear(x, params["proj2"])


def encode(params, mel: torch.Tensor, n_valid_frames: torch.Tensor, cfg: AudioEncoderConfig):
    """Run the encoder over a batch of clips.

    mel: [B, n_mels, T], T a multiple of ``cfg.n_window_infer``;
    n_valid_frames: int [B]. Returns (tokens [B, n_tokens, output_dim],
    n_valid_tokens int [B]); valid tokens are each row's prefix."""
    if mel.shape[-1] % cfg.n_window_infer:
        raise ValueError("pad mel to whole attention windows")
    n_valid_tokens = _valid_tokens(n_valid_frames.to(mel.device).long(), cfg)
    return _encode_core(params, mel, n_valid_tokens, cfg), n_valid_tokens
