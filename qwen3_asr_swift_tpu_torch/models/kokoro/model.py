"""Kokoro-82M TTS (StyleTTS2-derived KModel graph) on one device — port of
``qwen3_asr_swift_tpu/models/kokoro/model.py``.

BERT → duration → alignment → prosody (F0/N) → iSTFTNet decoder:

1. ALBERT over phoneme ids (``albert.py``) → ``bert_encoder`` 768 → 512.
2. The duration encoder (3 × [BiLSTM, AdaLayerNorm] with the style
   re-appended) → BiLSTM → sigmoid-sum duration head (50 bins) →
   round/clamp(min=1) / speed.
3. Alignment: each frame of a static budget takes the token
   ``searchsorted(cumsum(dur), frame, right)``; frames past the total are
   zero.
4. F0/N: a shared BiLSTM, then 3 AdainResBlk1d towers (the middle one
   upsamples ×2) and 1×1 heads.
5. Decoder: strided F0/N convs, the AdainResBlk1d encode/decode stack with
   the asr residual, then the iSTFTNet generator (harmonic source, noise
   convs and resblocks, 2 transposed-conv upsamples, AdaIN Snake
   resblocks, conv_post → magnitude and phase bins → iSTFT).

Both directions of a BiLSTM step together in one loop of device ops with
no host read (gate order i, f, g, o; fp32 sums); the backward direction
starts at the last valid step (packed-sequence semantics). AdaIN
statistics cover the valid prefix only, over the static frame budget the
reference keeps. Every conv is the port's ``conv1d`` (in fp32 a sum of
one matmul a tap: no TF32, each sum over one tap's input channels); the
transposed convs are tap products
overlap-added, with the taps as ``convert.py`` stores them (flipped). The
harmonic source's noise is a tensor argument; :meth:`KokoroTTS.synthesize`
draws it from a ``torch.Generator`` on the model's device seeded with
``seed``.

The reference's source runs at twice the generator's length: it repeats
the 2F-point F0 curve by ``samples_per_frame`` (the rate of a duration
frame), and the generator trims both to the shorter. The port keeps that
while the JAX package is the reference.

Voice packs: [510, 1, 256] tensors indexed by phoneme count; the first 128
dims condition the decoder, the last 128 the prosody predictor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import SpeechGenerationModel
from ...core.types import AudioChunk
from ...device import resolve_device
from ...ops.nn import (acc_dtype, conv1d, conv_transpose1d_full, layer_norm,
                        linear, lstm_loop, upcast)
from .albert import AlbertConfig, albert_config_tiny, albert_forward, draw_albert_params
from .phonemizer import VOCAB_SIZE, phonemize, phonemes_to_ids

SAMPLE_RATE = 24000
MAX_PHONEMES = 510


@dataclasses.dataclass(frozen=True)
class KokoroConfig:
    vocab_size: int = 178
    hidden_dim: int = 512          # d_model
    style_dim: int = 128           # per-branch style (voice vector is 2×)
    n_dur_layers: int = 3
    max_dur: int = 50
    text_kernel: int = 5
    albert: AlbertConfig = dataclasses.field(default_factory=AlbertConfig)
    # decoder / iSTFTNet generator
    decoder_dim: int = 1024
    asr_res_dim: int = 64
    upsample_rates: Tuple[int, ...] = (10, 6)
    upsample_kernels: Tuple[int, ...] = (20, 12)
    upsample_initial: int = 512
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[int, ...] = (1, 3, 5)
    gen_istft_n_fft: int = 20
    gen_istft_hop: int = 5
    nb_harmonics: int = 8
    voiced_threshold: float = 10.0
    sine_amp: float = 0.1
    noise_std: float = 0.003
    sample_rate: int = SAMPLE_RATE
    max_phonemes: int = MAX_PHONEMES

    @property
    def samples_per_frame(self) -> int:
        """Output samples per DURATION frame: the decoder's final
        AdainResBlk1d upsamples ×2 before the generator's upsample stack ×
        iSTFT hop (2·10·6·5 = 600 at 24 kHz — the published convention:
        hexgrad Kokoro emits duration.sum()·600 samples)."""
        return 2 * int(np.prod(self.upsample_rates)) * self.gen_istft_hop  # 600


CONFIG_82M = KokoroConfig()


def config_tiny() -> KokoroConfig:
    return KokoroConfig(
        vocab_size=VOCAB_SIZE, hidden_dim=16, style_dim=8, n_dur_layers=1, max_dur=6,
        text_kernel=3, albert=albert_config_tiny(),
        decoder_dim=16, asr_res_dim=4, upsample_rates=(2, 2), upsample_kernels=(4, 4),
        upsample_initial=16, resblock_kernels=(3,), resblock_dilations=(1, 2),
        gen_istft_n_fft=8, gen_istft_hop=2, max_phonemes=64)


# -- init (the reference's tree and scales) ------------------------------------------

def _draw_params(cfg: KokoroConfig, normal, zeros, ones) -> dict:
    d, sty = cfg.hidden_dim, cfg.style_dim

    def lin(d_in, d_out):
        return {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in)), "bias": zeros(d_out)}

    def lstm(i, h):
        s = 1.0 / np.sqrt(h)
        return {"wx": normal((i, 4 * h), s), "wh": normal((h, 4 * h), s), "bias": zeros(4 * h)}

    def bilstm(i, h):
        return {"fwd": lstm(i, h), "bwd": lstm(i, h)}

    def conv(width, cin, cout, bias=True):
        p = {"kernel": normal((width, cin, cout), 1.0 / np.sqrt(width * cin))}
        if bias:
            p["bias"] = zeros(cout)
        return p

    def adain(channels):
        return {"fc": lin(sty, channels * 2)}

    def resblk(cin, cout, upsample=False):
        p = {"norm1": adain(cin), "conv1": conv(3, cin, cout),
             "norm2": adain(cout), "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["conv1x1"] = conv(1, cin, cout, bias=False)
        if upsample:
            p["pool"] = conv(3, 1, cin)   # depthwise ConvTranspose1d(k 3, s 2)
        return p

    def resblock1(channels, kernel):
        n = len(cfg.resblock_dilations)
        return {
            "convs1": [conv(kernel, channels, channels) for _ in range(n)],
            "convs2": [conv(kernel, channels, channels) for _ in range(n)],
            "adain1": [adain(channels) for _ in range(n)],
            "adain2": [adain(channels) for _ in range(n)],
            "alpha1": [ones(channels) for _ in range(n)],
            "alpha2": [ones(channels) for _ in range(n)],
        }

    text_encoder = {
        "embedding": normal((cfg.vocab_size, d), 0.02),
        "cnn": [{"conv": conv(cfg.text_kernel, d, d), "ln": {"weight": ones(d), "bias": zeros(d)}}
                for _ in range(3)],
        "lstm": bilstm(d, d // 2),
    }
    predictor = {
        "dur_encoder": [{"lstm": bilstm(d + sty, d // 2), "ada_ln": {"fc": lin(sty, d * 2)}}
                        for _ in range(cfg.n_dur_layers)],
        "lstm": bilstm(d + sty, d // 2),
        "duration_proj": lin(d, cfg.max_dur),
        "shared": bilstm(d + sty, d // 2),
        "F0": [resblk(d, d), resblk(d, d // 2, upsample=True), resblk(d // 2, d // 2)],
        "F0_proj": conv(1, d // 2, 1),
        "N": [resblk(d, d), resblk(d, d // 2, upsample=True), resblk(d // 2, d // 2)],
        "N_proj": conv(1, d // 2, 1),
    }
    dec = cfg.decoder_dim
    ch0 = cfg.upsample_initial
    n_up = len(cfg.upsample_rates)
    stft_ch = cfg.gen_istft_n_fft + 2
    gen = {
        "m_source": lin(cfg.nb_harmonics + 1, 1),
        "noise_convs": [], "noise_res": [], "ups": [], "resblocks": [],
        "conv_post": conv(7, ch0 // (2 ** n_up), stft_ch),
    }
    for i in range(n_up):
        c_cur = ch0 // (2 ** (i + 1))
        if i + 1 < n_up:
            stride_f0 = int(np.prod(cfg.upsample_rates[i + 1:]))
            gen["noise_convs"].append(conv(stride_f0 * 2, stft_ch, c_cur))
            nk = 7
        else:
            gen["noise_convs"].append(conv(1, stft_ch, c_cur))
            nk = 11 if len(cfg.resblock_kernels) > 1 else cfg.resblock_kernels[-1]
        gen["noise_res"].append(resblock1(c_cur, nk))
        gen["ups"].append(conv(cfg.upsample_kernels[i], ch0 // (2 ** i), c_cur))
        for kern in cfg.resblock_kernels:
            gen["resblocks"].append(resblock1(c_cur, kern))
    decoder = {
        "F0_conv": conv(3, 1, 1),
        "N_conv": conv(3, 1, 1),
        "encode": resblk(d + 2, dec),
        "decode": [resblk(dec + 2 + cfg.asr_res_dim, dec) for _ in range(3)]
                  + [resblk(dec + 2 + cfg.asr_res_dim, ch0, upsample=True)],
        "asr_res": conv(1, d, cfg.asr_res_dim),
        "generator": gen,
    }
    return {
        "bert": draw_albert_params(cfg.albert, normal, zeros, ones),
        "bert_encoder": lin(cfg.albert.hidden_size, d),
        "text_encoder": text_encoder,
        "predictor": predictor,
        "decoder": decoder,
    }


def init_kokoro_params(rng: np.random.Generator, cfg: KokoroConfig) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(
        cfg, lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda n: np.zeros((n,), np.float32), lambda n: np.ones((n,), np.float32))


def init_kokoro_params_on_device(cfg: KokoroConfig, generator: torch.Generator) -> dict:
    """The same tree drawn on the generator's device."""
    dev = generator.device
    return _draw_params(
        cfg, lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda n: torch.zeros((n,), device=dev), lambda n: torch.ones((n,), device=dev))


# -- primitives (all NLC: [B, T, C]) --------------------------------------------------

def _bilstm(p, x: torch.Tensor, n_valid) -> torch.Tensor:
    """Masked bidirectional LSTM over [B, T, C]. The backward direction
    starts at the last VALID step (torch packed-sequence semantics): the
    valid region is reversed by a gather, scanned forward, un-gathered.
    ``n_valid`` an int or a 0-d tensor on x's device. Both directions step
    together, one loop iteration a step of device ops only (their products
    batched); torch gate order i, f, g, o, sums in fp32 (float64 in a
    float64 run); the loop is ``ops/nn.py::lstm_loop``."""
    t = x.shape[1]
    xs = x.transpose(0, 1)                                   # [T, B, C]
    idx = (n_valid - 1 - torch.arange(t, device=x.device)).clamp(0, t - 1)
    wx, wh, bias = (torch.stack([upcast(p["fwd"][k]), upcast(p["bwd"][k])])
                    for k in ("wx", "wh", "bias"))
    # one product a direction over all steps: [2, T·B, C] @ [2, C, 4h]
    # (a matmul against wx[:, None] would broadcast wx to every step)
    xd = upcast(torch.stack([xs, xs[idx]]))
    gx = torch.bmm(xd.reshape(2, -1, xd.shape[-1]), wx).reshape(*xd.shape[:3], -1)
    y = lstm_loop(gx, wh, bias).to(x.dtype)                  # [2, T, B, h]
    return torch.cat([y[0], y[1][idx]], dim=-1).transpose(0, 1)   # un-reverse: an involution


def _adain(x: torch.Tensor, p, s: torch.Tensor, n_valid=None, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over time, then the style's scale and shift. x [B, T,
    C], s [B, sty]; ``n_valid`` restricts the statistics to the valid
    prefix of the static frame budget."""
    h = linear(s, p["fc"])
    c = x.shape[-1]
    gamma, beta = h[:, :c], h[:, c:]
    xf = upcast(x)
    if n_valid is None:
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf - mean).square().mean(dim=1, keepdim=True)
    else:
        vm = (torch.arange(x.shape[1], device=x.device) < n_valid)[None, :, None].to(xf.dtype)
        denom = vm.sum(dim=1, keepdim=True).clamp_min(1.0)
        mean = (xf * vm).sum(dim=1, keepdim=True) / denom
        var = ((xf - mean).square() * vm).sum(dim=1, keepdim=True) / denom
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return ((1 + upcast(gamma[:, None])) * normed + upcast(beta[:, None])).to(x.dtype)


def _conv_same(x: torch.Tensor, p, dilation: int = 1, stride: int = 1) -> torch.Tensor:
    k = p["kernel"].shape[0]
    pad = (k - 1) * dilation // 2
    return conv1d(x, p, stride=stride, padding=pad, dilation=dilation)


def _conv_transpose_same(x: torch.Tensor, p, stride: int) -> torch.Tensor:
    """torch ConvTranspose1d(k, s, padding=(k-s)//2): trim (k-s)//2 a side."""
    k = p["kernel"].shape[0]
    y = conv_transpose1d_full(x, p["kernel"], stride)
    if "bias" in p:
        y = y + upcast(p["bias"])
    trim = (k - stride) // 2
    if trim > 0:
        y = y[:, trim:-trim]
    return y.to(x.dtype)


def _depthwise_convt_pool(x: torch.Tensor, p) -> torch.Tensor:
    """The AdainResBlk1d 'pool' when upsampling: depthwise
    ConvTranspose1d(k=3, s=2, padding=1, output_padding=1) — output 2T. The
    reference's lhs-dilated conv padded (1, 2) is the full transposed conv
    without its first sample."""
    y = conv_transpose1d_full(x, p["kernel"], 2)[:, 1:]
    if "bias" in p:
        y = y + upcast(p["bias"])
    return y.to(x.dtype)


def _lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x > 0, x, slope * x)


def _adain_resblk(x: torch.Tensor, p, s, upsample: bool = False, n_valid=None) -> torch.Tensor:
    """StyleTTS2 AdainResBlk1d: (residual + shortcut)/√2. x [B, T, C];
    ``n_valid`` the pre-upsample valid length (doubled inside)."""
    n2 = None if n_valid is None else (2 * n_valid if upsample else n_valid)
    h = _adain(x, p["norm1"], s, n_valid)
    h = _lrelu(h)
    if upsample:
        h = _depthwise_convt_pool(h, p["pool"])
    h = _conv_same(h, p["conv1"])
    h = _adain(h, p["norm2"], s, n2)
    h = _lrelu(h)
    h = _conv_same(h, p["conv2"])
    sc = x
    if upsample:
        sc = sc.repeat_interleave(2, dim=1)                  # nearest ×2
    if "conv1x1" in p:
        sc = _conv_same(sc, p["conv1x1"])
    return (h + sc) / np.sqrt(2.0)


def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a = upcast(alpha)[None, None, :]
    xf = upcast(x)
    sn = torch.sin(a * xf)
    return (xf + (1.0 / (a + 1e-9)) * sn * sn).to(x.dtype)


def _adain_resblock1(x: torch.Tensor, p, s, dilations, n_valid=None) -> torch.Tensor:
    """iSTFTNet AdaINResBlock1: AdaIN → Snake → dilated conv → AdaIN →
    Snake → conv → residual, per dilation."""
    h = x
    for j, d in enumerate(dilations):
        xt = _adain(h, p["adain1"][j], s, n_valid)
        xt = _snake(xt, p["alpha1"][j])
        xt = _conv_same(xt, p["convs1"][j], dilation=d)
        xt = _adain(xt, p["adain2"][j], s, n_valid)
        xt = _snake(xt, p["alpha2"][j])
        xt = _conv_same(xt, p["convs2"][j], dilation=1)
        h = h + xt
    return h


# -- sub-modules ------------------------------------------------------------------------

def text_encode(p, cfg: KokoroConfig, ids: torch.Tensor, n_valid, valid: torch.Tensor):
    """ids [B, T] → [B, T, d]: conv/LN blocks with masking, then the BiLSTM."""
    x = p["embedding"][ids.long()]
    m = valid[..., None]
    x = torch.where(m, x, 0.0)
    for blk in p["cnn"]:
        x = _conv_same(x, blk["conv"])
        x = layer_norm(x, blk["ln"]["weight"], blk["ln"]["bias"])
        x = _lrelu(x)
        x = torch.where(m, x, 0.0)
    x = _bilstm(p["lstm"], x, n_valid)
    return torch.where(m, x, 0.0)


def duration_encode(p, cfg: KokoroConfig, d_en: torch.Tensor, style: torch.Tensor, n_valid,
                    valid: torch.Tensor) -> torch.Tensor:
    """DurationEncoder: per layer a BiLSTM (d+sty → d), then AdaLayerNorm(d)
    and the style re-appended; returns [B, T, d+sty]."""
    b, t, _ = d_en.shape
    s_exp = style[:, None, :].expand(b, t, style.shape[-1]).to(d_en.dtype)
    m = valid[..., None]
    x = torch.where(m, torch.cat([d_en, s_exp], dim=-1), 0.0)
    for layer in p["dur_encoder"]:
        h = _bilstm(layer["lstm"], x, n_valid)                # [B, T, d]
        # AdaLayerNorm: non-affine LN over channels + style scale/shift
        fc = linear(style, layer["ada_ln"]["fc"])
        c = h.shape[-1]
        gamma, beta = fc[:, :c], fc[:, c:]
        hf = upcast(h)
        mean = hf.mean(dim=-1, keepdim=True)
        var = (hf - mean).square().mean(dim=-1, keepdim=True)
        h = ((1 + gamma[:, None]) * (hf - mean) * torch.rsqrt(var + 1e-5)
             + beta[:, None]).to(x.dtype)
        x = torch.where(m, torch.cat([h, s_exp], dim=-1), 0.0)
    return x


def prosody_f0n(p, cfg: KokoroConfig, en: torch.Tensor, style: torch.Tensor, n_frames=None):
    """en [B, F, d+sty] → (F0 [B, 2F], N [B, 2F])."""
    if n_frames is None:
        n_frames = en.shape[1]
    x = _bilstm(p["shared"], en, n_frames)
    outs = []
    for tower, proj in (("F0", "F0_proj"), ("N", "N_proj")):
        h, nv = x, n_frames
        for i, blk in enumerate(p[tower]):
            up = i == 1
            h = _adain_resblk(h, blk, style, upsample=up, n_valid=nv)
            nv = 2 * nv if up else nv
        outs.append(_conv_same(h, p[proj])[..., 0])
    return outs[0], outs[1]


@functools.lru_cache(maxsize=None)
def _stft_tables(n: int, device: torch.device, dtype: torch.dtype):
    """(the fused window·DFT kernel [n, 1, n + 2] of the source's STFT, and
    the iSTFT's IDFT matrices [n_bins, n] with conjugate symmetry folded in,
    the hann window [n] and its square), built once a device and dtype."""
    n_bins = n // 2 + 1
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))
    k_idx, n_idx = np.meshgrid(np.arange(n_bins), np.arange(n), indexing="ij")
    ang = 2.0 * np.pi * k_idx * n_idx / n
    stft = np.concatenate([(np.cos(ang) * w[None, :]).T, (-np.sin(ang) * w[None, :]).T],
                          axis=1)[:, None, :]
    mult = np.ones(n_bins)
    mult[1:(n + 1) // 2] = 2.0
    tables = (stft, np.cos(ang) * mult[:, None] / n, -np.sin(ang) * mult[:, None] / n, w, w * w)
    # the reference builds them in fp32
    return tuple(torch.tensor(np.asarray(v, np.float32), device=device).to(dtype) for v in tables)


def _gen_istft(spec: torch.Tensor, phase: torch.Tensor, cfg: KokoroConfig) -> torch.Tensor:
    """mag/phase [B, T', bins] → wav [B, S] (hann, torch.istft(center=True)
    framing). The frames and the window sum are overlap-added on the
    device, one slice a hop."""
    n, hop = cfg.gen_istft_n_fft, cfg.gen_istft_hop
    b, t = spec.shape[0], spec.shape[1]
    ct = acc_dtype(spec.dtype)
    _, a_mat, b_mat, w, w_sq = _stft_tables(n, spec.device, ct)
    real = spec * torch.cos(phase)
    imag = spec * torch.sin(phase)
    frames = (real.to(ct) @ a_mat + imag.to(ct) @ b_mat) * w
    seg = n // hop
    out_len = (t + seg - 1) * hop
    segments = frames.reshape(b, t, seg, hop)
    w_sq = w_sq.reshape(seg, hop)
    acc = torch.zeros((b, out_len), dtype=ct, device=spec.device)
    wsum = torch.zeros(out_len, dtype=ct, device=spec.device)
    for si in range(seg):
        acc[:, si * hop: si * hop + t * hop] += segments[:, :, si, :].reshape(b, t * hop)
        wsum[si * hop: si * hop + t * hop] += w_sq[si].repeat(t)
    c = n // 2
    return (acc / wsum.clamp_min(1e-8)[None, :])[:, c:-c] if out_len > 2 * c else acc


def source_noise(cfg: KokoroConfig, b: int, n_f0: int, generator: torch.Generator):
    """The harmonic source's draw from ``generator``: standard normal [B,
    n_f0·samples_per_frame, harmonics + 1], where n_f0 is the F0 curve's
    length (twice the frame budget)."""
    return torch.randn((b, n_f0 * cfg.samples_per_frame, cfg.nb_harmonics + 1),
                       generator=generator, device=generator.device)


def _harmonic_source(p, cfg: KokoroConfig, f0_frames: torch.Tensor, noise: torch.Tensor):
    """f0 [B, F] → (mag, phase) STFT of the NSF excitation, [B, F·spf/hop +
    1, 2·bins]; ``noise`` as :func:`source_noise` gives it."""
    spf = cfg.samples_per_frame
    f0_up = f0_frames.repeat_interleave(spf, dim=1)              # [B, S]
    ct = acc_dtype(f0_up.dtype)
    n_h = cfg.nb_harmonics + 1
    harmonics = torch.arange(1, n_h + 1, dtype=ct, device=f0_up.device)[None, :, None]
    # [B, harmonics, S]: the scan runs along the contiguous axis (a scan
    # over a strided outer axis is one sequential thread a column on the card)
    rad = f0_up[:, None, :] * harmonics / cfg.sample_rate
    uv = (f0_up > cfg.voiced_threshold).to(ct)[..., None]
    phase = torch.cumsum(rad, dim=-1).transpose(1, 2) * (2.0 * np.pi)
    sines = cfg.sine_amp * torch.sin(phase)
    noise_amp = uv * cfg.noise_std + (1.0 - uv) * cfg.sine_amp / 3.0
    sines = sines * uv + noise_amp * noise.to(ct)
    har = torch.tanh(linear(sines.to(f0_frames.dtype), p["m_source"]))[..., 0]   # [B, S]
    # STFT: center reflect pad, then one strided conv against window·DFT
    n, hop = cfg.gen_istft_n_fft, cfg.gen_istft_hop
    c = n // 2
    sig = torch.cat([har[:, 1:c + 1].flip(1), har, har[:, -c - 1:-1].flip(1)], dim=1)
    kernel = _stft_tables(n, sig.device, ct)[0]
    y = conv1d(sig.to(ct)[..., None], {"kernel": kernel}, stride=hop)
    n_bins = n // 2 + 1
    re, im = y[..., :n_bins], y[..., n_bins:]
    mag = torch.sqrt(re * re + im * im + 1e-12)
    ph = torch.atan2(im, re)
    return torch.cat([mag, ph], dim=-1)


def _source_branch(p, cfg: KokoroConfig, har: torch.Tensor, i: int, style, n_valid):
    """The source's STFT brought to upsample stage ``i``: its noise conv
    (strided down to the stage's rate) and its AdaIN resblock."""
    if i + 1 < len(cfg.upsample_rates):
        stride_f0 = int(np.prod(cfg.upsample_rates[i + 1:]))
        x_src = conv1d(har, p["noise_convs"][i], stride=stride_f0,
                            padding=(stride_f0 + 1) // 2)
    else:
        x_src = _conv_same(har, p["noise_convs"][i])
    return _adain_resblock1(x_src, p["noise_res"][i], style, cfg.resblock_dilations,
                            n_valid=n_valid)


def _generator_spectrum(p, cfg: KokoroConfig, x: torch.Tensor, style, har: torch.Tensor,
                        n_valid=None):
    """The generator's upsample stack, with the source injected at each
    stage, to its magnitude and phase bins [B, T', n_bins] each."""
    n_up = len(cfg.upsample_rates)
    n_k = len(cfg.resblock_kernels)
    for i in range(n_up):
        x = torch.where(x > 0, x, 0.1 * x)                       # LRELU_SLOPE
        x = _conv_transpose_same(x, p["ups"][i], cfg.upsample_rates[i])
        if n_valid is not None:
            n_valid = n_valid * cfg.upsample_rates[i]
        if i == n_up - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)                 # ReflectionPad1d((1, 0))
            if n_valid is not None:
                n_valid = n_valid + 1
        x_src = _source_branch(p, cfg, har.to(x.dtype), i, style, n_valid)
        m = min(x.shape[1], x_src.shape[1])
        x = x[:, :m] + x_src[:, :m]
        acc = _adain_resblock1(x, p["resblocks"][i * n_k], style, cfg.resblock_dilations,
                               n_valid=n_valid)
        for j in range(1, n_k):
            acc = acc + _adain_resblock1(x, p["resblocks"][i * n_k + j], style,
                                         cfg.resblock_dilations, n_valid=n_valid)
        x = acc / n_k
    x = torch.where(x > 0, x, 0.01 * x)
    x = _conv_same(x, p["conv_post"])
    n_bins = cfg.gen_istft_n_fft // 2 + 1
    return torch.exp(upcast(x[..., :n_bins])), torch.sin(upcast(x[..., n_bins:2 * n_bins]))


def generator(p, cfg: KokoroConfig, x: torch.Tensor, style, f0_frames, noise, n_valid=None):
    """iSTFTNet generator: x [B, F, upsample_initial] + style + F0 → wav.
    ``n_valid`` the valid length of x; it scales with each upsample."""
    har = _harmonic_source(p, cfg, f0_frames, noise)
    spec, phase = _generator_spectrum(p, cfg, x, style, har, n_valid)
    return _gen_istft(spec, phase, cfg)


def decoder_input(p, cfg: KokoroConfig, asr, f0_curve, n_curve, style, n_frames=None):
    """The decoder up to the generator: asr [B, F, d], F0/N [B, 2F] → (the
    generator's input [B, 2F, upsample_initial], its valid length)."""
    f0 = _conv_same(f0_curve[..., None], p["F0_conv"], stride=2)    # [B, F, 1]
    nn_ = _conv_same(n_curve[..., None], p["N_conv"], stride=2)
    x = torch.cat([asr, f0, nn_], dim=-1)
    x = _adain_resblk(x, p["encode"], style, n_valid=n_frames)
    asr_res = _conv_same(asr, p["asr_res"])
    res = True
    nv = n_frames
    for i, blk in enumerate(p["decode"]):
        up = i == len(p["decode"]) - 1
        if res:
            x = torch.cat([x, asr_res, f0, nn_], dim=-1)
        x = _adain_resblk(x, blk, style, upsample=up, n_valid=nv)
        if up:
            res = False
            nv = None if nv is None else 2 * nv
    return x, nv


def decode(p, cfg: KokoroConfig, asr, f0_curve, n_curve, style, noise, n_frames=None):
    """StyleTTS2 istftnet Decoder.forward: asr [B, F, d], F0/N [B, 2F]."""
    x, nv = decoder_input(p, cfg, asr, f0_curve, n_curve, style, n_frames)
    return generator(p["generator"], cfg, x, style, f0_curve, noise, n_valid=nv)


# -- full forward -------------------------------------------------------------------------

def predict_alignment(params, cfg: KokoroConfig, ids: torch.Tensor, n_valid, ref_s, speed,
                      max_frames: int):
    """BERT, the duration encoder and head, and the alignment: (the
    aligned prosody features en [B, F, d+sty], the frame mask [B, F, 1],
    the frame → token index [F], total frames (0-d), pred_dur [B, T], the
    pre-round durations [B, T], valid [B, T])."""
    b, t = ids.shape
    dev = ids.device
    valid = torch.arange(t, device=dev)[None, :] < n_valid
    s_pros = ref_s[:, cfg.style_dim:]
    bert_out = albert_forward(params["bert"], cfg.albert, ids, valid)
    d_en = linear(bert_out, params["bert_encoder"])                 # [B, T, d]
    d = duration_encode(params["predictor"], cfg, d_en, s_pros, n_valid, valid)
    x = _bilstm(params["predictor"]["lstm"], d, n_valid)
    duration = linear(x, params["predictor"]["duration_proj"])     # [B, T, max_dur]
    duration = torch.sigmoid(upcast(duration)).sum(dim=-1) / speed
    pred_dur = torch.clamp_min(torch.round(duration), 1.0).to(torch.int32)
    pred_dur = torch.where(valid, pred_dur, 0)
    # frame f ← token searchsorted(cumsum(dur), f, 'right')
    cum = torch.cumsum(pred_dur, dim=1)                             # [B, T]
    total = cum[:, -1]
    frames = torch.arange(max_frames, device=dev)
    tok_idx = torch.searchsorted(cum[0].long(), frames, right=True).clamp(0, t - 1)
    fmask = (frames < total[0])[None, :, None]
    en = torch.where(fmask, d[:, tok_idx], 0.0)                    # [B, F, d+sty]
    return en, fmask, tok_idx, total[0], pred_dur, duration, valid


def kokoro_forward(params, cfg: KokoroConfig, ids: torch.Tensor, n_valid, ref_s: torch.Tensor,
                   speed, noise: torch.Tensor, max_frames: int):
    """KModel.forward_with_tokens. ids [B=1, T] (0-padded), ``n_valid`` an
    int or 0-d tensor, ref_s [B, 2·sty], ``speed`` a 0-d tensor, ``noise``
    the source's draw (:func:`source_noise` at 2·max_frames) → (wav [B,
    S], total frames (0-d), pred_dur [T])."""
    en, fmask, tok_idx, total, pred_dur, _, valid = predict_alignment(
        params, cfg, ids, n_valid, ref_s, speed, max_frames)
    s_pros = ref_s[:, cfg.style_dim:]
    s_dec = ref_s[:, :cfg.style_dim]
    f0_pred, n_pred = prosody_f0n(params["predictor"], cfg, en, s_pros, total)
    t_en = text_encode(params["text_encoder"], cfg, ids, n_valid, valid)
    asr = torch.where(fmask, t_en[:, tok_idx], 0.0)
    wav = decode(params["decoder"], cfg, asr, f0_pred, n_pred, s_dec, noise, n_frames=total)
    return wav, total, pred_dur[0]


def trim_and_fade(wav: np.ndarray, sr: int = SAMPLE_RATE, window_s: float = 0.05,
                  silence_rms: float = 0.030, fade_s: float = 0.010) -> np.ndarray:
    """RMS-windowed trailing-artifact trim + fade
    (reference: KokoroTTS.swift:88-126 — 50 ms sustained-energy windows
    walked backwards, silenced tail, 10 ms linear fade)."""
    n = len(wav)
    if n == 0:
        return wav
    wav = wav.copy()
    win = max(1, int(window_s * sr))
    speech_end = n
    i = n - win
    while i > 0:
        rms = float(np.sqrt(np.mean(np.square(wav[i:i + win]))))
        if rms > silence_rms:
            speech_end = i + win
            break
        i -= win // 2
    if speech_end < n:
        wav[speech_end:] = 0.0
    fade = min(speech_end, int(fade_s * sr))
    if fade >= 2:
        wav[speech_end - fade:speech_end] *= np.linspace(1.0, 0.0, fade, dtype=np.float32)
    return wav


class KokoroTTS(SpeechGenerationModel):
    """Kokoro-82M on one device. ``params`` is a tree in the JAX package's
    layout (numpy arrays or tensors), carried onto ``device`` in ``dtype``.
    Public surface as the reference's (``synthesize(text, voice, language,
    speed)``, ``available_voices``, ``warm_up``)."""

    def __init__(self, cfg: KokoroConfig, params, voices: Optional[Dict[str, np.ndarray]] = None,
                 dtype: torch.dtype = torch.float32, lexicon=None, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        self.voices = voices or {"af_heart": np.zeros((cfg.style_dim * 2,), np.float32)}
        # instance-scoped pronunciation overlay (None = embedded dictionary)
        self.lexicon = lexicon
        #: the last synthesis's frame budget and the frames its durations filled
        self.last_budget = {"frames": 0, "spoken_frames": 0}
        self._loaded = True

    @classmethod
    def init_random(cls, cfg: Optional[KokoroConfig] = None, seed: int = 0, *,
                    device="cuda", **kw) -> "KokoroTTS":
        """Random weights drawn with numpy from ``seed``."""
        cfg = cfg or config_tiny()
        return cls(cfg, init_kokoro_params(np.random.default_rng(seed), cfg), device=device, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[KokoroConfig] = None, seed: int = 0, *,
                              device="cuda", **kw) -> "KokoroTTS":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``:
        the quick way to build the full-size model."""
        cfg = cfg or CONFIG_82M
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_kokoro_params_on_device(cfg, generator), device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "hexgrad/Kokoro-82M", cache_dir=None,
                        offline_mode: bool = False, dtype: torch.dtype = torch.float32,
                        **kw) -> "KokoroTTS":
        """Load a local checkpoint directory (``kokoro-v1_0.pth`` or
        per-module safetensors, ``voices/*.pt``, the gold/silver
        dictionaries). Hub download is not ported."""
        from ...core.hub import download_weights
        from .convert import convert_checkpoint, load_voices
        from .phonemizer import load_dictionaries

        model_dir = download_weights(
            model_id, cache_dir=cache_dir, offline_mode=offline_mode,
            additional_patterns=["*.pth", "voices/*", "*_gold.json", "*_silver.json"])
        params = convert_checkpoint(model_dir)
        voices = load_voices(model_dir)
        lexicon = load_dictionaries(model_dir)
        return cls(CONFIG_82M, params, voices=voices or None, dtype=dtype, lexicon=lexicon, **kw)

    @property
    def available_voices(self):
        return sorted(self.voices)

    def _ref_s(self, voice: str, n_tokens: int) -> np.ndarray:
        v = self.voices.get(voice)
        if v is None:
            raise KeyError(f"voice {voice!r} not found; available: {self.available_voices[:5]}")
        v = np.asarray(v, np.float32)
        if v.ndim >= 2:  # [510, 1, 256] published packs: index by token count
            v = v.reshape(v.shape[0], -1)[min(n_tokens - 1, v.shape[0] - 1)]
        return v[: self.cfg.style_dim * 2]

    def _source_noise(self, seed: int, n_f0: int) -> torch.Tensor:
        return source_noise(self.cfg, 1, n_f0, torch.Generator(device=self.device).manual_seed(seed))

    def prepare(self, text: str, voice: Optional[str] = None, language: str = "en",
                speed: float = 1.0):
        """The host half of :meth:`synthesize`: (ids [1, bucket] int32,
        n_valid, ref_s [1, 2·sty], the frame budget)."""
        voice = voice or self.available_voices[0]
        ids = phonemes_to_ids(phonemize(text, language, lexicon=self.lexicon))[
            : self.cfg.max_phonemes - 2]
        n_phonemes = len(ids)
        ids = [0, *ids, 0]  # pad tokens bracket the sequence (kokoro convention)
        n = len(ids)
        bucket = max(16, int(2 ** np.ceil(np.log2(n))))
        arr = np.zeros(bucket, np.int32)
        arr[:n] = ids
        # published packs index the style row by PHONEME count
        ref_s = self._ref_s(voice, max(1, n_phonemes))
        # frame budget: per-token durations reach ~24 frames at speed 1 but
        # scale by 1/speed
        per_tok = min(self.cfg.max_dur, int(np.ceil(24 / max(float(speed), 0.25))))
        return arr[None], n, ref_s[None], bucket * per_tok

    def synthesize(self, text: str, voice: Optional[str] = None, language: str = "en",
                   speed: float = 1.0, seed: int = 0, **kwargs) -> AudioChunk:
        ids, n, ref_s, max_frames = self.prepare(text, voice, language, speed)
        dev = self.device
        noise = self._source_noise(seed, 2 * max_frames)
        with torch.inference_mode():
            wav, total, _ = kokoro_forward(
                self.params, self.cfg, torch.as_tensor(ids, device=dev), n,
                torch.as_tensor(ref_s, device=dev).to(self.dtype),
                torch.tensor(speed, dtype=torch.float32, device=dev), noise, max_frames)
            total = int(total)
            samples = wav[0][: total * self.cfg.samples_per_frame].float().cpu().numpy()
        self.last_budget = {"frames": max_frames, "spoken_frames": total}
        return AudioChunk(trim_and_fade(samples, self.cfg.sample_rate), self.cfg.sample_rate)

    def warm_up(self) -> None:
        self.synthesize("hello")

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded
