"""Qwen3-TTS speech-tokenizer decoder: 16 codebooks → 24 kHz waveform —
port of ``qwen3_asr_swift_tpu/models/qwen3_tts/codec.py``.

Split RVQ (1 semantic + 15 acoustic codebooks) → causal pre-conv → a
small pre-transformer (RoPE, layer scales, SwiGLU) → 2×2 pre-upsampling
with ConvNeXt blocks → input conv → 4 decoder blocks (SnakeBeta, causal
transposed conv, 3 dilated residual units; strides 8, 5, 4, 3) →
SnakeBeta → final conv → clip. 1920 samples per 12.5 Hz frame.

Every convolution is causal, so decoding a chunk with enough left context
reproduces the full decode, and right-padding codes to a bucket of frames
and trimming the output is exact. The decoder runs in fp32; its convs are
tap matmuls (``ops/nn.py::conv1d``) and its transposed
convs a matmul and an overlap-add, so fp32 stays fp32 on the card (cuDNN's
fp32 convs default to TF32).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import _linear, _norm, _normal, params_from_jax
from ...device import resolve_device
from ...ops.attention import NEG_INF, sdpa
from ...ops.nn import conv1d, gelu, layer_norm, linear, rms_norm, silu
from ...ops.rope import apply_rope, rope_angles
from .config import CodecDecoderConfig


def _conv(rng, width: int, cin: int, cout: int, bias: bool = True) -> dict:
    p = {"kernel": _normal(rng, (width, cin, cout), 1.0 / np.sqrt(width * cin))}
    if bias:
        p["bias"] = np.zeros((cout,), np.float32)
    return p


def _snake(channels: int) -> dict:
    return {"alpha": np.zeros((channels,), np.float32), "beta": np.zeros((channels,), np.float32)}


def init_codec_params(rng: np.random.Generator, cfg: CodecDecoderConfig) -> dict:
    """Random decoder weights in the reference's layout, drawn with numpy."""
    latent, hid = cfg.latent_dim, cfg.hidden_size
    params = {
        "rvq_first": {
            "codebook": _normal(rng, (1, cfg.semantic_codebook_size, cfg.codebook_dim), 0.05),
            "output_proj": _conv(rng, 1, cfg.codebook_dim, hid, bias=False),
        },
        "rvq_rest": {
            "codebook": _normal(rng, (cfg.num_quantizers - 1, cfg.acoustic_codebook_size,
                                      cfg.codebook_dim), 0.05),
            "output_proj": _conv(rng, 1, cfg.codebook_dim, hid, bias=False),
        },
        "pre_conv": _conv(rng, 3, hid, latent),
        "transformer": {"input_proj": _linear(rng, latent, hid),
                        "output_proj": _linear(rng, hid, latent),
                        "norm": _norm(hid, bias=False), "layers": []},
        "pre_upsample": [],
        "input_conv": _conv(rng, 7, latent, cfg.decoder_dim),
        "blocks": [],
    }
    width = cfg.num_heads * cfg.head_dim
    for _ in range(cfg.num_layers):
        params["transformer"]["layers"].append({
            "norm1": _norm(hid, bias=False), "norm2": _norm(hid, bias=False),
            "q_proj": _linear(rng, hid, width, bias=False),
            "k_proj": _linear(rng, hid, width, bias=False),
            "v_proj": _linear(rng, hid, width, bias=False),
            "o_proj": _linear(rng, width, hid, bias=False),
            "gate_proj": _linear(rng, hid, hid * 2, bias=False),
            "up_proj": _linear(rng, hid, hid * 2, bias=False),
            "down_proj": _linear(rng, hid * 2, hid, bias=False),
            "attn_scale": np.full((hid,), 0.01, np.float32),
            "mlp_scale": np.full((hid,), 0.01, np.float32),
        })
    for ratio in cfg.upsampling_ratios:
        params["pre_upsample"].append({
            "upsample": _conv(rng, ratio * 2, latent, latent),
            "convnext": {"dw": _conv(rng, 7, 1, latent), "norm": _norm(latent, bias=True),
                         "pw1": _linear(rng, latent, latent * 4),
                         "pw2": _linear(rng, latent * 4, latent),
                         "layer_scale": np.full((latent,), 0.01, np.float32)},
        })
    dims = [cfg.decoder_dim]
    for _ in cfg.upsample_rates:
        dims.append(dims[-1] // 2)
    for i, rate in enumerate(cfg.upsample_rates):
        params["blocks"].append({
            "snake": _snake(dims[i]),
            "upsample": _conv(rng, rate * 2, dims[i], dims[i + 1]),
            "units": [{"snake1": _snake(dims[i + 1]),
                       "conv1": _conv(rng, 7, dims[i + 1], dims[i + 1]),
                       "snake2": _snake(dims[i + 1]),
                       "conv2": _conv(rng, 1, dims[i + 1], dims[i + 1])} for _ in range(3)],
        })
    params["final_snake"] = _snake(dims[-1])
    params["final_conv"] = _conv(rng, 7, dims[-1], 1)
    return params


def causal_conv1d(x: torch.Tensor, p, stride: int = 1, dilation: int = 1,
                  groups: int = 1) -> torch.Tensor:
    """x [B, T, C]; left-padded by (k-1)·dilation."""
    k = p["kernel"].shape[0]
    return conv1d(x, p, stride=stride, padding=(((k - 1) * dilation, 0),), groups=groups,
                  dilation=dilation)


def causal_transpose_conv1d(x: torch.Tensor, p, stride: int) -> torch.Tensor:
    """The reference's ``lax.conv_transpose`` (the input dilated by
    ``stride``, padded by k-1, cross-correlated with the kernel as given),
    trimmed by k - stride samples on the right: [B, T, Cin] → [B, T·stride,
    Cout]. Each input frame's taps come from one matmul; overlapping taps
    are summed by ``F.fold``."""
    kern = p["kernel"].to(x.dtype)                           # [k, Cin, Cout]
    k, _, cout = kern.shape
    b, t, _ = x.shape
    # tap j of input frame i lands on output i·stride + (k-1-j)
    taps = torch.matmul(x, kern.flip(0).permute(1, 0, 2).reshape(kern.shape[1], k * cout))
    taps = taps.reshape(b, t, k, cout).permute(0, 3, 2, 1).reshape(b, cout * k, t)
    n_out = (t - 1) * stride + k
    y = F.fold(taps, output_size=(1, n_out), kernel_size=(1, k), stride=(1, stride))
    y = y.reshape(b, cout, n_out).transpose(1, 2)
    if "bias" in p:
        y = y.float() + p["bias"].float()
    trim = k - stride
    if trim > 0:
        y = y[:, :-trim]
    return y.to(x.dtype)


def snake_beta(x: torch.Tensor, p) -> torch.Tensor:
    """x + (1/exp(beta))·sin²(exp(alpha)·x)."""
    a = torch.exp(p["alpha"].float())
    b = torch.exp(p["beta"].float())
    xf = x.float()
    s = torch.sin(a * xf)
    return (xf + (1.0 / b) * s * s).to(x.dtype)


def convnext_block(x: torch.Tensor, p) -> torch.Tensor:
    """Depthwise conv → LN → pw1 → GELU → pw2 → layer scale + residual."""
    h = causal_conv1d(x, p["dw"], groups=x.shape[-1])
    h = layer_norm(h, p["norm"]["weight"], p["norm"]["bias"], 1e-5)
    h = linear(gelu(linear(h, p["pw1"])), p["pw2"])
    return x + h * p["layer_scale"]


def rvq_decode(params, cfg: CodecDecoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, 16, T] → [B, T, hidden_size] (split RVQ sum, 1×1 projections)."""
    codes = codes.long()
    first = params["rvq_first"]["codebook"][0][codes[:, 0]]               # [B, T, cd]
    first = causal_conv1d(first, params["rvq_first"]["output_proj"])
    books = params["rvq_rest"]["codebook"]                                 # [15, V, cd]
    q = torch.arange(books.shape[0], device=codes.device)[None, :, None]
    summed = books[q, codes[:, 1:]].sum(dim=1)                             # [B, T, cd]
    return first + causal_conv1d(summed, params["rvq_rest"]["output_proj"])


def _pre_transformer(params, cfg: CodecDecoderConfig, x: torch.Tensor) -> torch.Tensor:
    p = params["transformer"]
    h = linear(x, p["input_proj"])
    b, t, _ = h.shape
    positions = torch.arange(t, device=x.device)[None].expand(b, t)
    rows = torch.arange(t, device=x.device)
    mask = torch.where(rows[None, :] <= rows[:, None], 0.0, NEG_INF).to(torch.float32)[None, None]
    cos, sin = rope_angles(positions, cfg.head_dim, 10000.0)
    cos, sin = cos[:, None], sin[:, None]
    for lp in p["layers"]:
        hh = rms_norm(h, lp["norm1"]["weight"], cfg.rms_norm_eps)
        q = linear(hh, lp["q_proj"]).reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = linear(hh, lp["k_proj"]).reshape(b, t, cfg.num_heads, cfg.head_dim)
        v = linear(hh, lp["v_proj"]).reshape(b, t, cfg.num_heads, cfg.head_dim)
        q = apply_rope(q.transpose(1, 2), cos, sin)
        k = apply_rope(k.transpose(1, 2), cos, sin)
        attn = sdpa(q, k, v.transpose(1, 2), 1.0 / np.sqrt(cfg.head_dim), mask)
        h = h + linear(attn.transpose(1, 2).reshape(b, t, -1), lp["o_proj"]) * lp["attn_scale"]
        hh = rms_norm(h, lp["norm2"]["weight"], cfg.rms_norm_eps)
        mlp = linear(silu(linear(hh, lp["gate_proj"])) * linear(hh, lp["up_proj"]),
                     lp["down_proj"])
        h = h + mlp * lp["mlp_scale"]
    h = rms_norm(h, p["norm"]["weight"], cfg.rms_norm_eps)
    return linear(h, p["output_proj"])


def codec_decode(params, cfg: CodecDecoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, 16, T] → waveform fp32 [B, T·1920]."""
    h = rvq_decode(params, cfg, codes)
    h = causal_conv1d(h, params["pre_conv"])
    h = _pre_transformer(params, cfg, h)
    for stage, ratio in zip(params["pre_upsample"], cfg.upsampling_ratios):
        h = causal_transpose_conv1d(h, stage["upsample"], ratio)
        h = convnext_block(h, stage["convnext"])
    h = causal_conv1d(h, params["input_conv"])
    for block, rate in zip(params["blocks"], cfg.upsample_rates):
        h = snake_beta(h, block["snake"])
        h = causal_transpose_conv1d(h, block["upsample"], rate)
        for unit in block["units"]:
            u = snake_beta(h, unit["snake1"])
            u = causal_conv1d(u, unit["conv1"], dilation=1)
            u = snake_beta(u, unit["snake2"])
            h = h + causal_conv1d(u, unit["conv2"])
    h = snake_beta(h, params["final_snake"])
    h = causal_conv1d(h, params["final_conv"])
    return torch.clamp(h[..., 0], -1.0, 1.0).float()


class CodecDecoder:
    """The decoder on one device (the card unless the caller asks for the
    CPU), with frame-count bucketing and chunked streaming decode."""

    #: frame-count bucketing quantum: the graph is causal, so right-padding
    #: codes to a bucket and trimming the output is exact
    DECODE_BUCKET_FRAMES = 8

    def __init__(self, params, cfg: CodecDecoderConfig, dtype=torch.float32, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params_from_jax(params, self.device, dtype)

    @torch.inference_mode()
    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        return codec_decode(self.params, self.cfg, codes.to(self.device))

    def decode(self, codes) -> np.ndarray:
        """codes [16, T] or [B, 16, T] → waveform [T·1920] / [B, T·1920]."""
        codes = np.asarray(codes)
        single = codes.ndim == 2
        if single:
            codes = codes[None]
        t = codes.shape[2]
        q = self.DECODE_BUCKET_FRAMES
        bucket = max(q, ((t + q - 1) // q) * q)
        if bucket != t:
            codes = np.pad(codes, ((0, 0), (0, 0), (0, bucket - t)))
        out = self._decode(torch.from_numpy(codes.astype(np.int64))).cpu().numpy()
        out = out[:, : t * self.cfg.samples_per_frame]
        return out[0] if single else out

    def decode_frames(self, codes: torch.Tensor, n: int) -> np.ndarray:
        """Codes as the frame loop leaves them on the device, [B, T_max, 16]:
        decode the first ``n`` frames (at their bucket) → [B, n·1920]."""
        q = self.DECODE_BUCKET_FRAMES
        bucket = max(q, min((n + q - 1) // q * q, codes.shape[1]))
        wav = self._decode(codes[:, :bucket].transpose(1, 2).contiguous())
        return wav.cpu().numpy()[:, : n * self.cfg.samples_per_frame]

    def decode_stream(self, codes, chunk: int = 25, left_context: int = 10
                      ) -> Iterator[np.ndarray]:
        """Yield waveform chunks of ``chunk`` frames, each decoded with up to
        ``left_context`` frames before it (the reference's chunkedDecode).
        Exact when the left context covers the whole prefix; with a bounded
        one it is the reference's approximation (the pre-transformer's
        window re-anchors per chunk)."""
        codes = np.asarray(codes)
        if codes.ndim == 2:
            codes = codes[None]
        if codes.shape[0] != 1:
            raise ValueError("decode_stream is single-utterance; decode() handles batches")
        t = codes.shape[2]
        spf = self.cfg.samples_per_frame
        pos = 0
        while pos < t:
            start = max(0, pos - left_context)
            end = min(t, pos + chunk)
            piece = torch.from_numpy(np.ascontiguousarray(codes[:, :, start:end]).astype(np.int64))
            wav = self._decode(piece).cpu().numpy()
            keep_from = (pos - start) * spf
            yield wav[0, keep_from: keep_from + (end - pos) * spf]
            pos = end
