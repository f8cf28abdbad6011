"""VoxCPM2 AudioVAE — DAC-style causal codec (16 kHz in → 64-d latents @
25 Hz → 48 kHz out); port of ``qwen3_asr_swift_tpu/models/voxcpm2/vae.py``.

  * ``Snake1d`` activations ``x + sin²(αx)/α`` with per-channel α,
  * encoder: CausalConv(k7) → 4 blocks (3 dilated depthwise residual units
    d=1/3/9 → snake → strided CausalConv k=2s, channel doubling from
    encoder_dim) → fc_mu CausalConv(k3) to latent_dim,
  * decoder: ConvStack(k7 depthwise + k1) → per-rate blocks (sample-rate
    scale/bias conditioning table → snake → causal transpose conv k=2s →
    3 depthwise residual units, channel halving from decoder_dim) → snake →
    conv_out k7 → tanh,
  * causal padding: left-pad ``2·pad − output_padding`` zeros then a VALID
    conv; transpose convs trim the same amount from the right.

Every conv is the port's ``conv1d`` (tap products, grouped where the
weight says so); the transposed convs are tap products overlap-added,
with the taps as ``convert.py`` stores them (flipped). The VAE runs in
fp32 whatever the model's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ...ops.nn import conv1d, conv_transpose1d_full


@dataclasses.dataclass(frozen=True)
class AudioVAEConfig:
    encoder_dim: int = 128
    encoder_rates: Tuple[int, ...] = (2, 5, 8, 8)
    latent_dim: int = 64
    decoder_dim: int = 2048
    decoder_rates: Tuple[int, ...] = (8, 6, 5, 2, 2, 2)
    depthwise: bool = True
    sample_rate: int = 16000
    out_sample_rate: int = 48000
    sr_bin_boundaries: Tuple[int, ...] = (20000, 30000, 40000)

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.encoder_rates))

    @property
    def decode_chunk_size(self) -> int:
        return int(np.prod(self.decoder_rates))


CONFIG_VAE = AudioVAEConfig()


def vae_config_tiny() -> AudioVAEConfig:
    return AudioVAEConfig(encoder_dim=4, encoder_rates=(2, 4), latent_dim=8,
                          decoder_dim=16, decoder_rates=(4, 3, 2),
                          sr_bin_boundaries=(20000,))


# -- primitives (NLC: [B, L, C]) ----------------------------------------------------

def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x [B, L, C]; alpha [C]."""
    a = alpha[None, None, :]
    s = torch.sin(a * x)
    return x + s * s / (a + 1e-9)


def causal_conv(x: torch.Tensor, p, *, stride: int = 1, dilation: int = 1, padding: int = 0,
                output_padding: int = 0) -> torch.Tensor:
    """Left-pad 2·padding − output_padding zeros, VALID. p["w"]: [k,
    in/groups, out]."""
    lead = max(0, 2 * padding - output_padding)
    groups = x.shape[-1] // p["w"].shape[1]
    y = conv1d(x, {"kernel": p["w"]}, stride=stride, padding=((lead, 0),), groups=groups,
               dilation=dilation)
    if "b" in p:
        y = y + p["b"]
    return y


def causal_transpose_conv(x: torch.Tensor, p, *, stride: int, padding: int,
                          output_padding: int) -> torch.Tensor:
    """The full transposed conv, trimmed by 2·padding − output_padding on
    the right. p["w"]: [k, in/groups, out], taps flipped."""
    y = conv_transpose1d_full(x, p["w"], stride).to(x.dtype)
    if "b" in p:
        y = y + p["b"]
    trim = 2 * padding - output_padding
    if trim > 0:
        y = y[:, :-trim]
    return y


def _residual_unit(x: torch.Tensor, p, dilation: int) -> torch.Tensor:
    h = snake(x, p["snake1"])
    h = causal_conv(h, p["conv1"], dilation=dilation, padding=3 * dilation)
    h = snake(h, p["snake2"])
    h = causal_conv(h, p["conv2"])
    return x + h


# -- encoder / decoder ------------------------------------------------------------------

def vae_encode(p, cfg: AudioVAEConfig, wave: torch.Tensor) -> torch.Tensor:
    """wave [B, S] at cfg.sample_rate (padded to hop multiples by the
    caller) → latents [B, S/hop, latent_dim]."""
    x = wave[:, :, None]
    x = causal_conv(x, p["encoder"]["conv_in"], padding=3)
    for bi, stride in enumerate(cfg.encoder_rates):
        bp = p["encoder"]["blocks"][bi]
        for ri, dil in enumerate((1, 3, 9)):
            x = _residual_unit(x, bp["res"][ri], dil)
        x = snake(x, bp["snake"])
        x = causal_conv(x, bp["conv"], stride=stride,
                        padding=int(np.ceil(stride / 2)), output_padding=stride % 2)
    return causal_conv(x, p["encoder"]["fc_mu"], padding=1)


def vae_decode(p, cfg: AudioVAEConfig, latents: torch.Tensor, sr: int | None = None):
    """latents [B, T, latent_dim] → wave [B, T·decode_chunk] at
    cfg.out_sample_rate."""
    sr = sr if sr is not None else cfg.out_sample_rate
    sr_idx = int(np.sum(np.asarray(cfg.sr_bin_boundaries) <= sr))
    # clamp to the checkpoint's table size (bin count is shape-inferred)
    sr_idx = min(sr_idx, p["decoder"]["blocks"][0]["sr_scale"].shape[0] - 1)
    x = latents
    x = causal_conv(x, p["decoder"]["conv_in0"], padding=3)
    x = causal_conv(x, p["decoder"]["conv_in1"])
    for bi, stride in enumerate(cfg.decoder_rates):
        bp = p["decoder"]["blocks"][bi]
        x = x * bp["sr_scale"][sr_idx][None, None] + bp["sr_bias"][sr_idx][None, None]
        x = snake(x, bp["snake"])
        x = causal_transpose_conv(x, bp["conv_t"], stride=stride,
                                  padding=int(np.ceil(stride / 2)), output_padding=stride % 2)
        for ri, dil in enumerate((1, 3, 9)):
            x = _residual_unit(x, bp["res"][ri], dil)
    x = snake(x, p["decoder"]["snake_out"])
    x = causal_conv(x, p["decoder"]["conv_out"], padding=3)
    return torch.tanh(x)[..., 0]


# -- init (the reference's tree and scales) -------------------------------------------

def draw_vae_params(cfg: AudioVAEConfig, normal, zeros, ones) -> dict:
    def conv(k_size, cin, cout, groups=1, bias=True):
        p = {"w": normal((k_size, cin // groups, cout), 1.0 / np.sqrt(k_size * cin / groups))}
        if bias:
            p["b"] = zeros((cout,))
        return p

    def res_unit(dim, groups):
        return {"snake1": ones((dim,)), "conv1": conv(7, dim, dim, groups=groups),
                "snake2": ones((dim,)), "conv2": conv(1, dim, dim)}

    enc_blocks = []
    d = cfg.encoder_dim
    for stride in cfg.encoder_rates:
        nxt = d * 2
        groups = nxt // 2 if cfg.depthwise else 1
        enc_blocks.append({"res": [res_unit(d, groups) for _ in range(3)],
                           "snake": ones((d,)), "conv": conv(2 * stride, d, nxt)})
        d = nxt
    encoder = {"conv_in": conv(7, 1, cfg.encoder_dim), "blocks": enc_blocks,
               "fc_mu": conv(3, d, cfg.latent_dim)}

    n_bins = len(cfg.sr_bin_boundaries) + 1
    dec_blocks = []
    for i, stride in enumerate(cfg.decoder_rates):
        din = cfg.decoder_dim // (1 << i)
        dout = cfg.decoder_dim // (1 << (i + 1))
        groups = dout if cfg.depthwise else 1
        dec_blocks.append({
            "sr_scale": ones((n_bins, din)), "sr_bias": zeros((n_bins, din)),
            "snake": ones((din,)), "conv_t": conv(2 * stride, din, dout),
            "res": [res_unit(dout, groups) for _ in range(3)],
        })
    d_last = cfg.decoder_dim // (1 << len(cfg.decoder_rates))
    decoder = {
        "conv_in0": conv(7, cfg.latent_dim, cfg.latent_dim,
                         groups=cfg.latent_dim if cfg.depthwise else 1),
        "conv_in1": conv(1, cfg.latent_dim, cfg.decoder_dim),
        "blocks": dec_blocks,
        "snake_out": ones((d_last,)),
        "conv_out": conv(7, d_last, 1),
    }
    return {"encoder": encoder, "decoder": decoder}
