"""CosyVoice3 HiFT vocoder (HiFi-GAN + iSTFT + neural source filter) —
port of ``qwen3_asr_swift_tpu/models/cosyvoice/hift.py``.

F0 predictor (5 causal convs + ELU + |linear|), nearest ×480 F0 upsample,
harmonic sine source (9 harmonics, tanh-merged), STFT(16/4) of the source
injected at each decoder stage, conv_pre (80 → 512, 4-frame look-ahead),
3 channel-halving stages (nearest upsample ×[8, 5, 3] + causal conv) each
with source injection and 3-kernel MRF resblocks (Snake, raw alpha),
conv_post → 9 log-magnitude + 9 phase bins → iSTFT overlap-add → ±0.99.

Every conv is the port's window-matmul ``conv1d`` (fp32 stays fp32, no
TF32); the STFT is one strided conv against the window·DFT kernel, the
iSTFT a matmul plus overlap-add. The source's three draws (phase, sine
noise, merged noise) come from the caller.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ...ops.nn import conv1d, linear


@dataclasses.dataclass(frozen=True)
class CosyHiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sample_rate: int = 24000
    nsf_alpha: float = 0.1        # sine amplitude
    nsf_sigma: float = 0.003      # additive noise std
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[int, ...] = (1, 3, 5)
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_down_strides: Tuple[int, ...] = (15, 3, 1)
    source_down_kernels: Tuple[int, ...] = (30, 6, 1)
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    conv_pre_kernel: int = 5      # right-padded (4-frame lookahead)
    f0_hidden: int = 512
    f0_layers: int = 5

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates))

    @property
    def samples_per_frame(self) -> int:
        return self.total_upsample * self.istft_hop_len  # 480


def hift_config_tiny() -> CosyHiFTConfig:
    return CosyHiFTConfig(
        in_channels=16, base_channels=32, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 3),
        istft_n_fft=8, istft_hop_len=2, resblock_kernel_sizes=(3,),
        source_resblock_kernel_sizes=(3, 3), source_down_strides=(2, 1),
        source_down_kernels=(4, 1), f0_hidden=16, f0_layers=2)


# -- init (the reference's tree and scales) ----------------------------------------

def _conv(normal, zeros, width, cin, cout):
    return {"kernel": normal((width, cin, cout), 1.0 / np.sqrt(width * cin)),
            "bias": zeros(cout)}


def _resblock(normal, zeros, ones, channels, kernel, n_dil):
    return {
        "convs1": [_conv(normal, zeros, kernel, channels, channels) for _ in range(n_dil)],
        "convs2": [_conv(normal, zeros, kernel, channels, channels) for _ in range(n_dil)],
        "alphas1": [ones(channels) for _ in range(n_dil)],
        "alphas2": [ones(channels) for _ in range(n_dil)],
    }


def draw_hift_params(cfg: CosyHiFTConfig, normal, zeros, ones) -> dict:
    n_stages = len(cfg.upsample_rates)
    n_dil = len(cfg.resblock_dilations)
    stft_ch = cfg.istft_n_fft + 2
    channels = [cfg.base_channels]
    for _ in range(n_stages):
        channels.append(channels[-1] // 2)

    def lin(d_in, d_out):
        return {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in)), "bias": zeros(d_out)}

    p = {
        "f0_condnet": [_conv(normal, zeros, 4 if i == 0 else 3,
                             cfg.in_channels if i == 0 else cfg.f0_hidden, cfg.f0_hidden)
                       for i in range(cfg.f0_layers)],
        "f0_classifier": lin(cfg.f0_hidden, 1),
        "source_linear": lin(cfg.nb_harmonics + 1, 1),
        "conv_pre": _conv(normal, zeros, cfg.conv_pre_kernel, cfg.in_channels,
                          cfg.base_channels),
        "ups": [], "source_downs": [], "source_resblocks": [], "resblocks": [],
        "conv_post": _conv(normal, zeros, 7, channels[-1], stft_ch),
    }
    for i in range(n_stages):
        p["ups"].append(_conv(normal, zeros, cfg.upsample_kernel_sizes[i], channels[i],
                              channels[i + 1]))
        p["source_downs"].append(_conv(normal, zeros, cfg.source_down_kernels[i], stft_ch,
                                       channels[i + 1]))
        p["source_resblocks"].append(_resblock(normal, zeros, ones, channels[i + 1],
                                               cfg.source_resblock_kernel_sizes[i], n_dil))
        for kernel in cfg.resblock_kernel_sizes:
            p["resblocks"].append(_resblock(normal, zeros, ones, channels[i + 1], kernel, n_dil))
    return p


# -- primitives (all NLC: [B, T, C]) ----------------------------------------------

def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + 1/(a + 1e-9)·sin²(a·x), raw alpha."""
    a = alpha.float()[None, None, :]
    xf = x.float()
    s = torch.sin(a * xf)
    return (xf + (1.0 / (a + 1e-9)) * s * s).to(x.dtype)


def _causal_conv(x, p, dilation=1, stride=1, pad_mode="left", pad_override=None):
    """Inputs follow the param dtype (the source STFT arrives fp32 whatever
    the model dtype); fp32 accumulation and bias."""
    k = p["kernel"].shape[0]
    pad = (k - 1) * dilation if pad_override is None else pad_override
    padding = ((pad, 0),) if pad_mode == "left" else ((0, pad),)
    return conv1d(x.to(p["kernel"].dtype), p, stride=stride, padding=padding,
                  dilation=dilation)


def _resblock_forward(x, rp, dilations):
    """snake → dilated conv → snake → conv (d 1) → residual, per dilation."""
    h = x
    for j, d in enumerate(dilations):
        xt = _snake(h, rp["alphas1"][j])
        xt = _causal_conv(xt, rp["convs1"][j], dilation=d)
        xt = _snake(xt, rp["alphas2"][j])
        xt = _causal_conv(xt, rp["convs2"][j], dilation=1)
        h = h + xt
    return h


def f0_predict(p, cfg: CosyHiFTConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, 80] → F0 [B, T] (Hz, non-negative). The first conv (k 4)
    is right-padded (look-ahead), the rest (k 3) causal; ELU between."""
    h = mel
    for i, cp in enumerate(p["f0_condnet"]):
        h = _causal_conv(h, cp, pad_mode="right" if i == 0 else "left")
        h = torch.where(h > 0, h, torch.exp(torch.clamp(h, max=0.0)) - 1.0)  # ELU
    return linear(h, p["f0_classifier"])[..., 0].abs()


def source_noise(cfg: CosyHiFTConfig, b: int, s: int, generator: torch.Generator):
    """The source's three draws from ``generator``: (phase [B, 1, H]
    uniform in [0, 2π), sine noise [B, S, H], merged noise [B, S, 1]
    standard normal)."""
    dev = generator.device
    n_h = cfg.nb_harmonics + 1
    phase = torch.rand((b, 1, n_h), generator=generator, device=dev) * (2.0 * np.pi)
    sine = torch.randn((b, s, n_h), generator=generator, device=dev)
    merged = torch.randn((b, s, 1), generator=generator, device=dev)
    return phase, sine, merged


def source_signal(p, cfg: CosyHiFTConfig, f0_up: torch.Tensor, phase0, sine_noise,
                  merged_noise) -> torch.Tensor:
    """f0_up [B, S] (sample rate) → excitation [B, S]; the draws as
    :func:`source_noise` gives them."""
    n_h = cfg.nb_harmonics + 1
    harmonics = torch.arange(1, n_h + 1, dtype=torch.float32, device=f0_up.device)
    freqs = f0_up[..., None] * harmonics[None, None, :] / cfg.sample_rate     # [B, S, H]
    uv = (f0_up > cfg.nsf_voiced_threshold).float()[..., None]
    phase = torch.cumsum(freqs * uv, dim=1) * (2.0 * np.pi)
    phase = phase + phase0
    sines = cfg.nsf_alpha * torch.sin(phase)
    noise = sine_noise * cfg.nsf_sigma
    sines = sines * uv + noise * (1.0 - uv)
    merged = torch.tanh(linear(sines, p["source_linear"]))                 # [B, S, 1]
    merged = merged + merged_noise * cfg.nsf_sigma
    return merged[..., 0]


def _stft_kernel(cfg: CosyHiFTConfig) -> np.ndarray:
    """Fused hann-window · DFT kernel [n_fft, 1, n_fft + 2] (real bins, then
    imaginary bins)."""
    n, n_bins = cfg.istft_n_fft, cfg.istft_n_fft // 2 + 1
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))
    k_idx, n_idx = np.meshgrid(np.arange(n_bins), np.arange(n), indexing="ij")
    ang = 2.0 * np.pi * k_idx * n_idx / n
    real = (np.cos(ang) * w[None, :]).T                              # [n, n_bins]
    imag = (-np.sin(ang) * w[None, :]).T
    return np.concatenate([real, imag], axis=1)[:, None, :].astype(np.float32)


def stft_source(sig: torch.Tensor, cfg: CosyHiFTConfig) -> torch.Tensor:
    """sig [B, S] → [B, T', n_fft + 2]: reflect pad, then one strided conv."""
    n, hop = cfg.istft_n_fft, cfg.istft_hop_len
    c = n // 2
    sig = torch.cat([sig[:, 1:c + 1].flip(1), sig, sig[:, -c - 1:-1].flip(1)], dim=1)
    kernel = torch.from_numpy(_stft_kernel(cfg)).to(sig.device)
    return conv1d(sig.float()[..., None], {"kernel": kernel}, stride=hop)


@functools.lru_cache(maxsize=None)
def _istft_tables(n: int, device: torch.device):
    """The IDFT matrices [n_bins, n] (conjugate symmetry folded in: bins
    1..n_bins-2 count twice), the hann window [n] and its square, fp32 on
    ``device``: built once, not on every call."""
    n_bins = n // 2 + 1
    mult = np.ones(n_bins)
    mult[1:n - n_bins + 1] = 2.0
    k_idx, n_idx = np.meshgrid(np.arange(n_bins), np.arange(n), indexing="ij")
    ang = 2.0 * np.pi * k_idx * n_idx / n
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (np.cos(ang) * mult[:, None] / n, -np.sin(ang) * mult[:, None] / n,
                           w, w * w))


def istft(mag: torch.Tensor, phase: torch.Tensor, cfg: CosyHiFTConfig) -> torch.Tensor:
    """mag/phase [B, T', n_bins] → wav [B, (T' + n/hop - 1)·hop] with the
    hann window-sum normalization; the frames and the window-sum are both
    overlap-added on the device, one slice a hop."""
    n, hop = cfg.istft_n_fft, cfg.istft_hop_len
    b, t = mag.shape[0], mag.shape[1]
    a_mat, b_mat, w, w_sq = _istft_tables(n, mag.device)

    real = mag * torch.cos(phase)
    imag = mag * torch.sin(phase)
    frames = (real.float() @ a_mat + imag.float() @ b_mat) * w

    seg = n // hop
    out_len = (t + seg - 1) * hop
    segments = frames.reshape(b, t, seg, hop)
    w_sq = w_sq.reshape(seg, hop)
    acc = torch.zeros((b, out_len), dtype=torch.float32, device=mag.device)
    wsum = torch.zeros(out_len, dtype=torch.float32, device=mag.device)
    for s in range(seg):
        acc[:, s * hop: s * hop + t * hop] += segments[:, :, s, :].reshape(b, t * hop)
        wsum[s * hop: s * hop + t * hop] += w_sq[s].repeat(t)
    return acc / wsum.clamp_min(1e-8)[None, :]


def hift_generate(p, cfg: CosyHiFTConfig, mel: torch.Tensor, noise) -> torch.Tensor:
    """mel [B, T, 80] → wav [B, T·480]; ``noise`` the source's draws
    (:func:`source_noise` at S = T·480)."""
    f0 = f0_predict(p, cfg, mel)                                     # [B, T]
    f0_up = f0.repeat_interleave(cfg.samples_per_frame, dim=1)       # [B, T·480]
    src = source_signal(p, cfg, f0_up, *noise)                       # [B, T·480]
    src_stft = stft_source(src, cfg)                                 # [B, T', 18]

    x = _causal_conv(mel, p["conv_pre"], pad_mode="right")           # [B, T, 512]
    n_stages = len(cfg.upsample_rates)
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(n_stages):
        x = torch.where(x > 0, x, cfg.lrelu_slope * x)
        x = x.repeat_interleave(cfg.upsample_rates[i], dim=1)        # nearest upsample
        x = _causal_conv(x, p["ups"][i])
        if i == n_stages - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)                     # ReflectionPad1d((1, 0))
        stride = cfg.source_down_strides[i]
        if stride > 1:
            s = _causal_conv(src_stft, p["source_downs"][i], stride=stride,
                             pad_override=stride - 1)
        else:
            s = _causal_conv(src_stft, p["source_downs"][i])
        s = _resblock_forward(s, p["source_resblocks"][i], cfg.resblock_dilations)
        m = min(x.shape[1], s.shape[1])
        x = x[:, :m] + s[:, :m]
        fused = _resblock_forward(x, p["resblocks"][i * n_k], cfg.resblock_dilations)
        for j in range(1, n_k):
            fused = fused + _resblock_forward(x, p["resblocks"][i * n_k + j],
                                              cfg.resblock_dilations)
        x = fused / n_k

    x = torch.where(x > 0, x, 0.01 * x)                              # final leaky (0.01)
    x = _causal_conv(x, p["conv_post"])                              # [B, T_f, 18]
    n_bins = cfg.istft_n_fft // 2 + 1
    mag = torch.exp(x[..., :n_bins].float())
    phase = torch.sin(x[..., n_bins:2 * n_bins].float())
    wav = istft(mag, phase, cfg)
    return wav.clamp(-cfg.audio_limit, cfg.audio_limit)
