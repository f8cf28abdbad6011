"""Log-mel over a fixed frame budget — port of ``qwen3_asr_swift_tpu/ops/mel.py``.

The host half is a copy of the reference's numpy code: ``MelConfig``,
the filterbank and windowed-DFT constructors, ``num_frames``,
``reflect_pad_np`` and the per-frame FFT golden ``log_mel_reference``.
The device half, :func:`log_mel_kernel`, is a frame gather, the windowed
DFT as two matmuls (cos and sin), the power spectrum, a mel matmul, then
log10 / max-clamp / normalize over the valid frames only, batched over
clips; its constant matrices are cached per device. :func:`reflect_pad`
pads on the device, and :class:`MelFrontend` is the reference's bucketed
extractor over :func:`log_mel_kernel`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

MAX_MEL_FRAMES = 120_000  # 1200 s at 16 kHz / hop 160


def hz_to_mel_slaney(hz: np.ndarray) -> np.ndarray:
    """HF-style Slaney mel scale: linear below 1 kHz, log above."""
    hz = np.asarray(hz, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / math.log(6.4)
    safe = np.maximum(hz, 1e-12)  # both where-branches evaluate; avoid log(0)
    return np.where(hz < min_log_hz, 3.0 * hz / 200.0, min_log_mel + np.log(safe / min_log_hz) * logstep)


def mel_to_hz_slaney(mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    min_log_mel = 15.0
    logstep = math.log(6.4) / 27.0
    return np.where(mel < min_log_mel, 200.0 * mel / 3.0, 1000.0 * np.exp((mel - min_log_mel) * logstep))


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_mels: int = 128,
    n_freqs: int = 257,
    sample_rate: int = 16000,
    padded_fft: int = 512,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape [n_freqs, n_mels]."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    fft_freqs = np.arange(n_freqs, dtype=np.float64) * sample_rate / padded_fft
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    filter_freqs = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(filter_freqs)

    # Triangular filters via up/down slopes (HF _create_triangular_filter_bank).
    slopes = filter_freqs[None, :] - fft_freqs[:, None]  # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    enorm = 2.0 / (filter_freqs[2:] - filter_freqs[:-2])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)  # [n_freqs, n_mels]


@functools.lru_cache(maxsize=8)
def windowed_dft(n_fft: int = 400, padded_fft: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """(window ⊙ cos, window ⊙ sin) real-DFT matrices, each [n_fft, bins].

    Folding the Hann window into the DFT basis turns STFT into a single
    matmul per (cos, sin) — the zero-padded tail of each frame contributes
    nothing, so rows beyond n_fft vanish."""
    bins = padded_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
    k = np.arange(bins, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(n, k) / padded_fft  # [n_fft, bins]
    cos_m = (window[:, None] * np.cos(phase)).astype(np.float32)
    sin_m = (window[:, None] * -np.sin(phase)).astype(np.float32)
    return cos_m, sin_m


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 128
    padded_fft: int = 512
    # Whisper-style log normalization: log10 → clamp(max-8) → (x+4)/4
    log_clamp_floor: float = 1e-10
    dynamic_range: float = 8.0
    max_frames: int = MAX_MEL_FRAMES

    @property
    def n_freqs(self) -> int:
        return self.padded_fft // 2 + 1


def num_frames(cfg: MelConfig, n_samples: int) -> int:
    """Frames produced for raw audio of length n_samples, after the
    reference's reflect-pad and drop-last-frame semantics."""
    padded = n_samples + 2 * (cfg.n_fft // 2)
    raw = (padded - cfg.n_fft) // cfg.hop_length + 1
    return min(max(raw - 1, 0), cfg.max_frames)


def _reflect_indices(n: int, pad: int):
    left_src = np.maximum(np.minimum(np.arange(pad, 0, -1), n - 1), 0)
    right_src = np.maximum(n - 2 - np.arange(pad), 0)
    return left_src, right_src


def reflect_pad(audio: torch.Tensor, pad: int) -> torch.Tensor:
    """Reference-exact reflect pad (device): mirror without repeating the
    edge sample, degenerating gracefully for signals shorter than the pad."""
    left_src, right_src = (torch.from_numpy(i).to(audio.device)
                           for i in _reflect_indices(audio.shape[-1], pad))
    return torch.cat([audio[..., left_src], audio, audio[..., right_src]], dim=-1)


def reflect_pad_np(audio: np.ndarray, pad: int) -> np.ndarray:
    left_src, right_src = _reflect_indices(audio.shape[-1], pad)
    return np.concatenate([audio[..., left_src], audio, audio[..., right_src]], axis=-1)


_consts_lock = threading.Lock()
_consts: dict = {}


def _constants(cfg: MelConfig, device: torch.device):
    key = (cfg, str(device))
    with _consts_lock:
        if key not in _consts:
            cos_m, sin_m = windowed_dft(cfg.n_fft, cfg.padded_fft)
            fb = mel_filterbank(cfg.n_mels, cfg.n_freqs, cfg.sample_rate, cfg.padded_fft)
            _consts[key] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                 for a in (cos_m, sin_m, fb))
        return _consts[key]


def log_mel_kernel(padded_audio: torch.Tensor, n_valid_frames: torch.Tensor,
                   cfg: MelConfig, total_frames: int) -> torch.Tensor:
    """padded_audio fp32 [B, (total_frames-1)*hop + n_fft] (already
    reflect-padded and zero-extended); n_valid_frames int [B] →
    fp32 [B, n_mels, total_frames] (padding frames zeroed)."""
    dev = padded_audio.device
    cos_m, sin_m, fb = _constants(cfg, dev)
    idx = (torch.arange(total_frames, device=dev)[:, None] * cfg.hop_length
           + torch.arange(cfg.n_fft, device=dev)[None, :])
    frames = padded_audio.float()[:, idx]                    # [B, frames, n_fft]
    re = frames @ cos_m
    im = frames @ sin_m
    mel = (re * re + im * im) @ fb                           # [B, frames, n_mels]
    log_spec = torch.log10(torch.clamp(mel, min=cfg.log_clamp_floor))
    valid = torch.arange(total_frames, device=dev)[None, :] < n_valid_frames.to(dev)[:, None]
    masked = torch.where(valid[..., None], log_spec, torch.full_like(log_spec, -float("inf")))
    global_max = masked.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, global_max - cfg.dynamic_range)
    log_spec = (log_spec + 4.0) / 4.0
    log_spec = torch.where(valid[..., None], log_spec, torch.zeros_like(log_spec))
    return log_spec.transpose(1, 2)


class MelFrontend:
    """Host-facing mel extractor with length bucketing, on ``device``.

    Arbitrary-length audio is reflect-padded on the host, zero-padded up to
    the next frame-budget bucket and run through :func:`log_mel_kernel`
    with its valid-frame count, as the reference's one program per bucket
    is; a 30 s clip is 3 matmuls of shape [3000,400]@[400,257] +
    [3000,257]@[257,128].
    """

    # Bucket boundaries in seconds (frames = seconds * 100 at 16 kHz/160 hop)
    DEFAULT_BUCKETS_S = (1, 2, 5, 10, 20, 30, 60, 120, 300, 600, 1200)

    def __init__(self, cfg: MelConfig = MelConfig(), buckets_s=DEFAULT_BUCKETS_S,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._frame_buckets = [
            min(int(s * cfg.sample_rate / cfg.hop_length), cfg.max_frames) for s in buckets_s
        ]

    def _bucket_for(self, frames_needed: int) -> int:
        for b in self._frame_buckets:
            if frames_needed <= b:
                return b
        return self.cfg.max_frames

    def padded_len_for_frames(self, frames: int) -> int:
        """Padded-signal samples the kernel reads for a `frames` budget."""
        return (frames - 1) * self.cfg.hop_length + self.cfg.n_fft

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        """audio: [n_samples] float32 at cfg.sample_rate →
        [n_mels, n_valid_frames] float32 (on device, sliced on host)."""
        audio = np.atleast_1d(np.asarray(audio, np.float32))
        if len(audio) < 2:  # reflect padding indexes sample 1
            audio = np.pad(audio, (0, 2 - len(audio)))
        n_valid = num_frames(self.cfg, len(audio))
        bucket = self._bucket_for(n_valid)
        padded = reflect_pad_np(audio.astype(np.float32), self.cfg.n_fft // 2)
        need = self.padded_len_for_frames(bucket)
        if len(padded) < need:
            padded = np.pad(padded, (0, need - len(padded)))
        else:
            padded = padded[:need]
        out = self.device_call(torch.from_numpy(padded).to(self.device),
                               torch.tensor(n_valid, dtype=torch.int32), total_frames=bucket)
        return out[:, :n_valid].cpu().numpy()

    def device_call(self, padded_audio: torch.Tensor, n_valid_frames,
                    total_frames: int) -> torch.Tensor:
        """On-device variant for larger pipelines: ``padded_audio`` fp32
        ``[L]``, already reflect-padded (:func:`reflect_pad`) →
        ``[n_mels, total_frames]``."""
        n_valid = torch.as_tensor(n_valid_frames).reshape(1)
        return log_mel_kernel(padded_audio[None], n_valid, self.cfg, total_frames)[0]


# ---------------------------------------------------------------------------
# Pure-numpy reference (for golden-parity tests, mirrors the reference's
# vDSP pipeline step by step)
# ---------------------------------------------------------------------------

def log_mel_reference(audio: np.ndarray, cfg: MelConfig = MelConfig()) -> np.ndarray:
    """Direct per-frame FFT implementation of the same semantics; the unit
    tests pin the XLA kernel against this (golden-fixture strategy,
    reference: Tests/SpeechWakeWordTests fbank parity)."""
    pad = cfg.n_fft // 2
    n = len(audio)
    left_src = np.maximum(np.minimum(np.arange(pad, 0, -1), n - 1), 0)
    right_src = np.maximum(n - 2 - np.arange(pad), 0)
    padded = np.concatenate([audio[left_src], audio, audio[right_src]])

    n_frames = (len(padded) - cfg.n_fft) // cfg.hop_length + 1
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(cfg.n_fft) / cfg.n_fft))
    mags = np.empty((n_frames, cfg.n_freqs), dtype=np.float64)
    for f in range(n_frames):
        frame = padded[f * cfg.hop_length : f * cfg.hop_length + cfg.n_fft] * window
        spec = np.fft.rfft(frame, n=cfg.padded_fft)
        mags[f] = np.abs(spec) ** 2

    fb = mel_filterbank(cfg.n_mels, cfg.n_freqs, cfg.sample_rate, cfg.padded_fft).astype(np.float64)
    mel = mags @ fb
    log_spec = np.log10(np.maximum(mel, cfg.log_clamp_floor))
    # drop the last frame BEFORE the max-normalization (HF Whisper drops
    # it from the magnitudes before any statistic; the jitted kernel masks
    # it out of global_max the same way)
    log_spec = log_spec[: n_frames - 1]
    log_spec = np.maximum(log_spec, log_spec.max() - cfg.dynamic_range)
    log_spec = (log_spec + 4.0) / 4.0
    log_spec = log_spec[: cfg.max_frames]
    return log_spec.T.astype(np.float32)  # [n_mels, frames]
