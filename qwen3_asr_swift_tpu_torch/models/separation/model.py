"""Music source separation: Open-Unmix (UMX) + Wiener post-filter — port
of ``qwen3_asr_swift_tpu/models/separation/model.py``.

44.1 kHz stereo → STFT (4096/1024, centred Hann, reflect padding) → per-stem
spectrogram model (input scale/mean → fc1 + BN + tanh → 3-layer BiLSTM,
256 a direction, + skip → fc2 + BN + ReLU → fc3 + BN → output scale →
ReLU mask) → magnitude estimates → single-pass Wiener soft mask across
stems → iSTFT.

The DFT and its inverse are matmuls. The overlap-add sums the N_FFT/HOP
= 4 frame phases as strided adds into one buffer (the frames of one phase
do not overlap), which is deterministic on the card; a scatter-add such as
``index_add_`` sums in another order from run to run there. All stems run
together: each BiLSTM layer is one loop over the frames for the stems'
weights and both directions at once (a batched product over 2·S weight
sets), with each direction's input product one ``bmm`` over every frame
taken before the loop.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import SourceSeparationModel
from ...device import resolve_device
from ...ops.nn import lstm_loop

STEMS = ("vocals", "drums", "bass", "other")
N_FFT = 4096
HOP = 1024
SR = 44100


# -- STFT as matmul ----------------------------------------------------------

@functools.lru_cache(maxsize=2)
def _dft(n_fft=N_FFT):
    n = np.arange(n_fft)
    window = np.hanning(n_fft + 1)[:-1]
    k = np.arange(n_fft // 2 + 1)
    phase = 2 * np.pi * np.outer(n, k) / n_fft
    return (
        (window[:, None] * np.cos(phase)).astype(np.float32),
        (window[:, None] * -np.sin(phase)).astype(np.float32),
        window.astype(np.float32),
    )


@functools.lru_cache(maxsize=2)
def _idft(bins: int = N_FFT // 2 + 1):
    """The inverse real DFT's bases [bins, n_fft] (without the analysis
    window), each bin's weight folded in as the reference applies it."""
    n = np.arange(N_FFT)
    k = np.arange(bins)
    phase = 2 * np.pi * np.outer(k, n) / N_FFT
    scale = np.ones(bins, np.float32) * 2.0
    scale[0] = 1.0
    scale[-1] = 1.0
    return (scale, (np.cos(phase) / N_FFT).astype(np.float32),
            (np.sin(phase) / N_FFT).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, dtype: torch.dtype, bins: int = N_FFT // 2 + 1):
    """:func:`_dft`'s and :func:`_idft`'s arrays on ``device`` (each DFT
    matrix 34 MB in fp32): copied once, not on every call."""
    return tuple(torch.from_numpy(m).to(device, dtype) for m in _dft() + _idft(bins))


def stft(x: torch.Tensor, n_frames: int):
    """x [C, T] → (re, im) [C, F, bins]."""
    cos_m, sin_m = _tables(x.device, x.dtype)[:2]
    pad = N_FFT // 2
    xp = torch.nn.functional.pad(x[None], (pad, pad), mode="reflect")[0]
    frames = xp.unfold(-1, N_FFT, HOP)[:, :n_frames]          # [C, F, n_fft]
    return frames @ cos_m, frames @ sin_m


def overlap_add(frames: torch.Tensor) -> torch.Tensor:
    """frames [..., F, N_FFT] → [..., (F-1)·HOP + N_FFT], summed phase by
    phase: the frames f ≡ j (mod N_FFT/HOP) tile the output without
    overlapping, so each phase is one strided add into the buffer."""
    *lead, f, n = frames.shape
    out = frames.new_zeros((*lead, (f - 1) * HOP + n))
    for j in range(n // HOP):
        part = frames[..., j::n // HOP, :]
        width = part.shape[-2] * n
        if width:
            out[..., j * HOP: j * HOP + width] += part.reshape(*lead, width)
    return out


def istft(re: torch.Tensor, im: torch.Tensor, out_len: int) -> torch.Tensor:
    """(re, im) [..., F, bins] → [..., out_len] via overlap-add (inverse DFT
    as a matmul, synthesis window, Σw² normalisation)."""
    window, scale, icos, isin = _tables(re.device, re.dtype, re.shape[-1])[2:]
    frames = (re * scale) @ icos - (im * scale) @ isin        # [..., F, n_fft]
    out = overlap_add(frames * window)
    norm = overlap_add((window * window).expand(frames.shape[-2], -1))
    out = out / torch.clamp(norm, min=1e-8)
    pad = N_FFT // 2
    return out[..., pad: pad + out_len]


# -- UMX stem model ----------------------------------------------------------

def _draw_params(normal, zeros, ones, nb_bins: int, hidden: int, channels: int) -> dict:
    lstm_hidden = hidden // 2

    def lin(i, o):
        return {"kernel": normal((i, o), 1.0 / np.sqrt(i))}

    def lstm(i, h):
        return {"wx": normal((i, 4 * h), 1.0 / np.sqrt(i)),
                "wh": normal((h, 4 * h), 1.0 / np.sqrt(h)), "bias": zeros(4 * h)}

    return {
        "input_mean": zeros(nb_bins),
        "input_scale": ones(nb_bins),
        "fc1": lin(nb_bins * channels, hidden),
        "bn1": {"scale": ones(hidden), "bias": zeros(hidden)},
        "lstm_fwd": [lstm(hidden, lstm_hidden) for _ in range(3)],
        "lstm_bwd": [lstm(hidden, lstm_hidden) for _ in range(3)],
        "fc2": lin(hidden * 2, hidden),
        "bn2": {"scale": ones(hidden), "bias": zeros(hidden)},
        "fc3": lin(hidden, 2049 * channels),
        "bn3": {"scale": ones(2049 * channels), "bias": zeros(2049 * channels)},
        "output_scale": ones(2049),
        "output_mean": zeros(2049),
    }


def init_umx_params(rng: np.random.Generator, nb_bins: int = 1487, hidden: int = 512,
                    channels: int = 2) -> dict:
    """One stem's network, drawn with numpy, in the reference's tree.
    nb_bins = cropped frequency bins (UMX-HQ: 1487 of 2049 ≈ 16 kHz)."""
    return _draw_params(
        lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda n: np.zeros((n,), np.float32), lambda n: np.ones((n,), np.float32),
        nb_bins, hidden, channels)


def init_umx_params_on_device(generator: torch.Generator, nb_bins: int = 1487,
                              hidden: int = 512, channels: int = 2) -> dict:
    """The same tree drawn on the generator's device."""
    dev = generator.device
    return _draw_params(
        lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda n: torch.zeros((n,), device=dev), lambda n: torch.ones((n,), device=dev),
        nb_bins, hidden, channels)


def stack_stems(stem_params: Sequence[dict]) -> dict:
    """The stems' trees → one tree whose leaves carry a leading stem axis."""
    def walk(nodes):
        if isinstance(nodes[0], dict):
            return {k: walk([n[k] for n in nodes]) for k in nodes[0]}
        if isinstance(nodes[0], (list, tuple)):
            return [walk([n[i] for n in nodes]) for i in range(len(nodes[0]))]
        return torch.stack(nodes)
    return walk(list(stem_params))


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def bilstm_stems(pf, pb, x: torch.Tensor) -> torch.Tensor:
    """One bidirectional LSTM layer for S stems at once (batch 1 each):
    x [S, F, D] and each direction's weights with a leading stem axis →
    [S, F, 2h]. One loop over the frames steps the 2·S weight sets."""
    s = x.shape[0]
    wx, wh, bias = (torch.cat([pf[k], pb[k]]) for k in ("wx", "wh", "bias"))
    xd = torch.cat([x, x.flip(1)])                                # [2S, F, D]
    y = lstm_loop(torch.bmm(xd, wx)[:, :, None], wh, bias)[:, :, 0]   # [2S, F, h]
    return torch.cat([y[:s], y[s:].flip(1)], dim=-1)


def umx_forward_stems(stacked, mag: torch.Tensor, nb_bins: int = 1487) -> torch.Tensor:
    """stacked: the stems' trees stacked (:func:`stack_stems`); mag
    [F, bins, C] magnitude spectrogram → mask-applied magnitude estimates
    [S, F, 2049, C] (UMX applies its ReLU mask output directly)."""
    f, bins, c = mag.shape
    x = mag[:, :nb_bins, :]
    # upstream convention: the checkpoint stores the NEGATED mean and the
    # reciprocal std, applied as (x + input_mean) * input_scale
    x = (x + stacked["input_mean"][:, None, :, None]) * stacked["input_scale"][:, None, :, None]
    s = x.shape[0]
    x = x.transpose(2, 3).reshape(s, f, c * nb_bins)
    h = torch.tanh(torch.bmm(x, stacked["fc1"]["kernel"]) * stacked["bn1"]["scale"][:, None]
                   + stacked["bn1"]["bias"][:, None])
    seq = h
    for lf, lb in zip(stacked["lstm_fwd"], stacked["lstm_bwd"]):
        seq = bilstm_stems(lf, lb, seq)
    # UMX skip connection: concat(input, lstm_out) → fc2, cut or zero-padded
    # to fc2's input width
    fc2_in = stacked["fc2"]["kernel"].shape[1]
    h = torch.cat([h, seq], dim=-1)[..., :fc2_in]
    if h.shape[-1] < fc2_in:
        h = torch.nn.functional.pad(h, (0, fc2_in - h.shape[-1]))
    h = torch.relu(torch.bmm(h, stacked["fc2"]["kernel"]) * stacked["bn2"]["scale"][:, None]
                   + stacked["bn2"]["bias"][:, None])
    h = (torch.bmm(h, stacked["fc3"]["kernel"]) * stacked["bn3"]["scale"][:, None]
         + stacked["bn3"]["bias"][:, None])
    full_bins = stacked["output_scale"].shape[1]
    h = h.reshape(s, f, c, full_bins).transpose(2, 3)
    h = h * stacked["output_scale"][:, None, :, None] + stacked["output_mean"][:, None, :, None]
    return torch.relu(h) * mag


def umx_forward(params, mag: torch.Tensor, nb_bins: int = 1487) -> torch.Tensor:
    """One stem: mag [F, bins, C] → its magnitude estimate [F, 2049, C]."""
    return umx_forward_stems(stack_stems([params]), mag, nb_bins)[0]


def wiener_masks(estimates: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Single-iteration Wiener soft mask: power-ratio of stem estimates
    (reference: WienerFilter). estimates: [S, F, bins, C]."""
    power = estimates ** 2
    total = power.sum(dim=0) + eps
    return power / total[None]


def separate_spectra(stacked, audio: torch.Tensor, n_frames: int, out_len: int) -> torch.Tensor:
    """audio [C, T] → the stems' signals [S, C, out_len]."""
    re, im = stft(audio, n_frames)                                # [C, F, bins]
    mag = torch.sqrt(re ** 2 + im ** 2).permute(1, 2, 0)          # [F, bins, C]
    masks = wiener_masks(umx_forward_stems(stacked, mag)).permute(0, 3, 1, 2)   # [S, C, F, bins]
    return istft(re * masks, im * masks, out_len)


class SourceSeparator(SourceSeparationModel):
    """Open-Unmix on one device (the card unless the caller asks for the
    CPU). ``stem_params`` maps a stem's name to its tree in the reference's
    layout; the stems' trees are kept stacked, once."""

    def __init__(self, stem_params: Dict[str, dict], dtype: torch.dtype = torch.float32, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        #: the stems' names, in the order of ``params``' leading axis
        self.stems = tuple(stem_params)
        #: every stem's weights in one tree, stacked along a leading axis
        self.params = stack_stems([params_from_jax(stem_params[s], self.device, dtype)
                                   for s in self.stems])
        #: the last ``separate``'s BiLSTM loop: {"frames", "iterations"}
        #: (one iteration a frame a layer, every stem and direction in it)
        self.last_loop = {"frames": 0, "iterations": 0}
        self._loaded = True

    @classmethod
    def init_random(cls, seed: int = 0, stems: Sequence[str] = STEMS, *, device="cuda",
                    **kw) -> "SourceSeparator":
        """Random weights at the published widths, one ``torch.Generator``
        seeded ``seed`` on the host drawing the stems in turn."""
        g = torch.Generator().manual_seed(seed)
        return cls({s: init_umx_params_on_device(g) for s in stems}, device=device, **kw)

    @classmethod
    def init_random_on_device(cls, seed: int = 0, stems: Sequence[str] = STEMS, *,
                              device="cuda", **kw) -> "SourceSeparator":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        return cls({s: init_umx_params_on_device(g) for s in stems}, device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "open-unmix/umxhq", cache_dir=None,
                        offline_mode: bool = False, **kw) -> "SourceSeparator":
        """A directory of per-stem ``.pth`` or ``.safetensors`` files, local,
        cached or fetched (``core/hub.py``)."""
        from ...core.hub import download_weights
        from .convert import load_umx_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode,
                                     patterns=("*.pth", "*.safetensors", "*.json"))
        return cls(load_umx_checkpoint(model_dir), **kw)

    @property
    def stem_params(self) -> Dict[str, dict]:
        """{stem: its tree}, each leaf a view into ``params``."""
        return {s: _map_leaves(lambda leaf, i=i: leaf[i], self.params)
                for i, s in enumerate(self.stems)}

    def stacked(self, stems: Sequence[str]) -> dict:
        """The named stems' weights stacked along a leading axis: ``params``
        itself for every stem in order, else a gathered copy."""
        if tuple(stems) == self.stems:
            return self.params
        idx = torch.tensor([self.stems.index(s) for s in stems], device=self.device)
        return _map_leaves(lambda leaf: leaf.index_select(0, idx), self.params)

    @torch.inference_mode()
    def separate(self, audio: np.ndarray, sample_rate: int,
                 stems: Optional[Sequence[str]] = None) -> dict:
        """audio: [T] mono or [C, T] stereo. Returns {stem: [C, T]}."""
        if audio.ndim == 1:
            audio = np.stack([audio, audio])
        if sample_rate != SR:
            from ...audio.resample import resample

            audio = np.stack([resample(ch.astype(np.float32), sample_rate, SR) for ch in audio])
        want = list(stems or self.stems)
        t = audio.shape[1]
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device, self.dtype)
        params = self.stacked(want)
        outs = separate_spectra(params, x, t // HOP + 1, t).float().cpu().numpy()
        self.last_loop = {"frames": t // HOP + 1,
                          "iterations": len(params["lstm_fwd"]) * (t // HOP + 1)}
        return {s: outs[i] for i, s in enumerate(want)}

    def warm_up(self) -> None:
        self.separate(np.zeros((2, SR), np.float32), SR)

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded


def signal_to_distortion_ratio(estimate: np.ndarray, target: np.ndarray, eps=1e-10) -> float:
    """Simple SDR in dB (reference: SourceSeparationMetrics.swift)."""
    num = float(np.sum(target ** 2))
    den = float(np.sum((target - estimate) ** 2))
    return 10.0 * np.log10((num + eps) / (den + eps))
