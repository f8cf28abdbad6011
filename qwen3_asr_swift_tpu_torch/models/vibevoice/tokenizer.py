"""VibeVoice σ-VAE acoustic tokenizer (encoder + streaming decoder) — port
of ``qwen3_asr_swift_tpu/models/vibevoice/tokenizer.py``.

Encodec-style causal conv stacks: an SConv stem, per-stage strided
downsamples (ratios reversed for the encoder), Block1D towers
(ConvRMSNorm → depthwise conv k7 → layer-scale γ; RMSNorm → GELU FFN →
γ_ffn) and a head conv to the 64-d latent (7.5 Hz at 24 kHz, total ratio
3200). The decoder mirrors them with causal SConvTranspose upsamples
(trim right). σ-VAE sampling adds ``fix_std``·noise to the mean latent; the
noise comes from the caller.

Every conv is the port's ``conv1d`` (fp32 stays fp32); the
transposed convs are ``qwen3_tts/codec.py::causal_transpose_conv1d`` (one
matmul, then ``F.fold``), which is the reference's ``lax.conv_transpose``
trimmed on the right. Every conv is causal, so a chunked decode with a left
context at least the decoder's receptive field reproduces the full decode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.nn import conv1d, linear, rms_norm
from ..qwen3_tts.codec import causal_transpose_conv1d


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    channels: int = 1
    vae_dim: int = 64
    n_filters: int = 32
    ratios: Tuple[int, ...] = (8, 5, 5, 4, 2, 2)       # decoder order
    depths: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 8)    # per stage
    kernel: int = 7
    layer_scale_init: float = 1e-6
    rms_eps: float = 1e-5
    fix_std: float = 0.5
    disable_last_norm: bool = True

    @property
    def total_ratio(self) -> int:
        return int(np.prod(self.ratios))

    @property
    def encoder_ratios(self) -> Tuple[int, ...]:
        return tuple(reversed(self.ratios))

    @property
    def decoder_latent_receptive(self) -> int:
        """Latent-domain left receptive field of the causal decoder: the
        minimum ``left_context`` for which chunked decode is exact. Each
        causal conv of kernel k holds k-1 left taps at its stage's rate;
        dividing by the cumulative upsample converts to latent frames."""
        k1 = self.kernel - 1
        rf = k1 * (1 + self.depths[0])       # stage-0 conv + its blocks
        u = 1
        for i in range(1, len(self.depths)):
            rf += int(np.ceil(k1 / u))       # upsample conv (pre-upsample rate)
            u *= self.ratios[i - 1]
            rf += self.depths[i] * int(np.ceil(k1 / u))
        rf += int(np.ceil(k1 / u))           # head conv
        return rf


def tokenizer_config_tiny() -> TokenizerConfig:
    return TokenizerConfig(vae_dim=8, n_filters=4, ratios=(4, 2), depths=(1, 1, 1),
                           kernel=3)


# -- init (the reference's tree and scales) ----------------------------------

def draw_tokenizer_params(cfg: TokenizerConfig, normal, zeros, ones, full) -> dict:
    n_stages = len(cfg.depths)
    n_down = len(cfg.ratios)

    def conv(width, cin, cout):
        return {"kernel": normal((width, cin, cout), 1.0 / np.sqrt(width * cin)),
                "bias": zeros(cout)}

    def block(dim):
        return {
            "norm": {"weight": ones(dim)},
            "mixer": conv(cfg.kernel, 1, dim),                   # depthwise: [k, 1, dim]
            "gamma": full(dim, cfg.layer_scale_init),
            "ffn_norm": {"weight": ones(dim)},
            "ffn1": {"kernel": normal((dim, 4 * dim), 1.0 / np.sqrt(dim)), "bias": zeros(4 * dim)},
            "ffn2": {"kernel": normal((4 * dim, dim), 1.0 / np.sqrt(4 * dim)), "bias": zeros(dim)},
            "ffn_gamma": full(dim, cfg.layer_scale_init),
        }

    def ch_enc(i):
        return cfg.n_filters * (2 ** i)

    def ch_dec(i):  # decoder stage i channels
        return cfg.n_filters * (2 ** (n_stages - 1 - i))

    enc_ratios = cfg.encoder_ratios
    enc = {"downsample_layers": [conv(cfg.kernel, cfg.channels, cfg.n_filters)]
           + [conv(enc_ratios[i] * 2, ch_enc(i), ch_enc(i + 1)) for i in range(n_down)],
           "stages": [block(ch_enc(i)) for i in range(n_stages) for _ in range(cfg.depths[i])],
           "head": conv(cfg.kernel, ch_enc(n_stages - 1), cfg.vae_dim)}
    dec = {"upsample_layers": [conv(cfg.kernel, cfg.vae_dim, ch_dec(0))]
           + [conv(cfg.ratios[i] * 2, ch_dec(i), ch_dec(i + 1)) for i in range(n_down)],
           "stages": [block(ch_dec(i)) for i in range(n_stages) for _ in range(cfg.depths[i])],
           "head": conv(cfg.kernel, ch_dec(n_stages - 1), cfg.channels)}
    return {"encoder": enc, "decoder": dec}


# -- convs (all NLC: [B, T, C]) ----------------------------------------------

def _sconv(x: torch.Tensor, p, stride: int = 1) -> torch.Tensor:
    """Encodec SConv1d, causal: left pad (k-1)-(s-1), extra right pad to
    complete the last frame."""
    k = p["kernel"].shape[0]
    pad_total = (k - 1) - (stride - 1)
    length = x.shape[1]
    n_frames = (length - k + pad_total) / stride + 1
    ideal = (int(np.ceil(n_frames)) - 1) * stride + (k - pad_total)
    extra = max(ideal - length, 0)
    return conv1d(x.to(p["kernel"].dtype), p, stride=stride, padding=((pad_total, extra),))


def _sconv_transpose(x: torch.Tensor, p, stride: int) -> torch.Tensor:
    """Causal SConvTranspose1d: the full transpose, trimmed by k - s on the
    right (the kernel as the converter leaves it: taps flipped, [k, in,
    out])."""
    return causal_transpose_conv1d(x.to(p["kernel"].dtype), p, stride)


def _sconv_depthwise(x: torch.Tensor, p, dim: int) -> torch.Tensor:
    k = p["kernel"].shape[0]
    return conv1d(x.to(p["kernel"].dtype), p, padding=((k - 1, 0),), groups=dim)


def _block(x: torch.Tensor, p, cfg: TokenizerConfig) -> torch.Tensor:
    dim = x.shape[-1]
    h = rms_norm(x, p["norm"]["weight"], cfg.rms_eps)
    h = _sconv_depthwise(h, p["mixer"], dim)
    x = x + h * p["gamma"].to(x.dtype)
    h = rms_norm(x, p["ffn_norm"]["weight"], cfg.rms_eps)
    h = linear(F.gelu(linear(h, p["ffn1"]), approximate="none"), p["ffn2"])
    return x + h * p["ffn_gamma"].to(x.dtype)


def encode(p, cfg: TokenizerConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, S] → mean latents [B, T_lat, vae_dim]."""
    x = audio[..., None]
    offsets = np.cumsum([0] + list(cfg.depths))
    enc_ratios = cfg.encoder_ratios
    for i in range(len(cfg.depths)):
        stride = 1 if i == 0 else enc_ratios[i - 1]
        x = _sconv(x, p["encoder"]["downsample_layers"][i], stride=stride)
        for j in range(offsets[i], offsets[i + 1]):
            x = _block(x, p["encoder"]["stages"][j], cfg)
    return _sconv(x, p["encoder"]["head"])


def sample_latents(latents: torch.Tensor, noise: torch.Tensor, fix_std: float) -> torch.Tensor:
    """σ-VAE sampling: mean + fix_std·ε, ε the caller's standard normal."""
    return latents + fix_std * noise.to(latents.dtype)


def decode(p, cfg: TokenizerConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents [B, T_lat, vae_dim] → audio [B, T_lat · total_ratio]."""
    x = latents
    offsets = np.cumsum([0] + list(cfg.depths))
    for i in range(len(cfg.depths)):
        if i == 0:
            x = _sconv(x, p["decoder"]["upsample_layers"][0])
        else:
            x = _sconv_transpose(x, p["decoder"]["upsample_layers"][i], cfg.ratios[i - 1])
        for j in range(offsets[i], offsets[i + 1]):
            x = _block(x, p["decoder"]["stages"][j], cfg)
    return _sconv(x, p["decoder"]["head"])[..., 0]


def decode_chunked(p, cfg: TokenizerConfig, latents: torch.Tensor, chunk: int = 16,
                   left_context: Optional[int] = None) -> torch.Tensor:
    """Chunked decode with the left context recomputed: every conv of the
    decoder is causal, so with ``left_context`` at least the latent-domain
    receptive field (the default) the samples equal the full decode."""
    if left_context is None:
        left_context = cfg.decoder_latent_receptive
    t = latents.shape[1]
    spf = cfg.total_ratio
    outs = []
    start = 0
    while start < t:
        ctx = min(left_context, start)
        end = min(start + chunk, t)
        wav = decode(p, cfg, latents[:, start - ctx:end])
        outs.append(wav[:, ctx * spf:])
        start = end
    return torch.cat(outs, dim=1)
