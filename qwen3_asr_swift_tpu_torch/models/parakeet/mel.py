"""NeMo-style log-mel frontend for Parakeet — port of
``qwen3_asr_swift_tpu/models/parakeet/mel.py``.

Pre-emphasis 0.97 → centered STFT (n_fft 512, win 400 Hann centered, hop
160) → power spectrum → 128-bank Slaney mel → log(x + 2⁻²⁴) → per-feature
mean/std normalization over VALID frames. The host halves
(:func:`nemo_windowed_dft`, :func:`prepare_nemo_audio`,
:func:`nemo_log_mel_reference`) are numpy, copied; :func:`nemo_log_mel`
runs on the audio's device as a gather and two DFT matmuls.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ...ops.mel import mel_filterbank
from .config import ParakeetConfig


@functools.lru_cache(maxsize=4)
def nemo_windowed_dft(n_fft: int = 512, win_length: int = 400) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [n_fft, n_fft/2+1] with a periodic Hann window of
    win_length centered in the n_fft frame (torch.stft semantics)."""
    bins = n_fft // 2 + 1
    window = np.zeros(n_fft)
    hann = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    off = (n_fft - win_length) // 2
    window[off : off + win_length] = hann
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(bins, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(n, k) / n_fft
    return (
        (window[:, None] * np.cos(phase)).astype(np.float32),
        (window[:, None] * -np.sin(phase)).astype(np.float32),
    )


def nemo_num_frames(cfg: ParakeetConfig, n_samples: int) -> int:
    return 1 + n_samples // cfg.hop_length  # torch.stft center=True


def prepare_nemo_audio(audio: np.ndarray, cfg: ParakeetConfig):
    """Host prep: pre-emphasis on the TRUE signal, then centered reflect pad
    (torch.stft center=True semantics). Returns (padded signal, n_frames).
    Zero-extend the result to the bucket before calling :func:`nemo_log_mel`
    — boundary frames then match the unpadded computation exactly, keeping
    the per-feature normalization stable."""
    x = audio.astype(np.float32)
    x = np.concatenate([x[:1], x[1:] - cfg.pre_emphasis * x[:-1]]) if len(x) > 1 else x
    pad = cfg.n_fft // 2
    n = len(x)
    left = x[np.minimum(np.arange(pad, 0, -1), n - 1)]
    right = x[np.maximum(n - 2 - np.arange(pad), 0)]
    return np.concatenate([left, x, right]), 1 + n // cfg.hop_length


@functools.lru_cache(maxsize=16)
def _bases(cfg: ParakeetConfig, device: torch.device):
    """The DFT bases and the mel filterbank as fp32 tensors on ``device``,
    made once a device."""
    cos_m, sin_m = nemo_windowed_dft(cfg.n_fft, cfg.win_length)
    fb = mel_filterbank(cfg.num_mel_bins, cfg.n_fft // 2 + 1, cfg.sample_rate, cfg.n_fft)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(m).to(device) for m in (cos_m, sin_m, fb))


def nemo_log_mel(padded_audio: torch.Tensor, n_valid_frames: torch.Tensor, cfg: ParakeetConfig,
                 total_frames: int):
    """padded_audio [B, L] fp32 — rows of :func:`prepare_nemo_audio`'s
    output, zero-extended to ≥ (total_frames-1)*hop + n_fft; n_valid_frames
    [B] int. Returns ([B, total_frames, n_mels] fp32 normalized per row
    over its valid frames, zero past them; n_valid_frames)."""
    dev = padded_audio.device
    idx = (torch.arange(total_frames, device=dev)[:, None] * cfg.hop_length
           + torch.arange(cfg.n_fft, device=dev)[None, :])
    frames = padded_audio[:, idx]                               # [B, F, 512]
    cos_m, sin_m, fb = _bases(cfg, dev)
    re, im = frames @ cos_m, frames @ sin_m
    power = re * re + im * im
    log_mel = torch.log(power @ fb + cfg.log_zero_guard)        # [B, F, n_mels]

    n_valid = n_valid_frames.to(dev)
    valid = (torch.arange(total_frames, device=dev)[None, :] < n_valid[:, None])[..., None]
    zero = log_mel.new_zeros(())
    cnt = torch.clamp(n_valid, min=1).to(torch.float32)[:, None, None]
    mean = torch.where(valid, log_mel, zero).sum(dim=1, keepdim=True) / cnt
    var = torch.where(valid, (log_mel - mean) ** 2, zero).sum(dim=1, keepdim=True) \
        / torch.clamp(cnt - 1, min=1)
    normed = (log_mel - mean) / (torch.sqrt(var) + 1e-5)
    return torch.where(valid, normed, zero), n_valid_frames


def nemo_log_mel_reference(audio: np.ndarray, cfg: ParakeetConfig) -> np.ndarray:
    """Per-frame numpy reference for parity tests."""
    x = audio.astype(np.float64)
    x = np.concatenate([x[:1], x[1:] - cfg.pre_emphasis * x[:-1]])
    pad = cfg.n_fft // 2
    padded = np.concatenate([x[pad:0:-1], x, x[-2 : -2 - pad : -1] if len(x) > pad + 1 else np.zeros(pad)])
    n_frames = 1 + len(x) // cfg.hop_length
    window = np.zeros(cfg.n_fft)
    hann = 0.5 * (1 - np.cos(2 * np.pi * np.arange(cfg.win_length) / cfg.win_length))
    off = (cfg.n_fft - cfg.win_length) // 2
    window[off : off + cfg.win_length] = hann
    spec = np.empty((n_frames, cfg.n_fft // 2 + 1))
    for f in range(n_frames):
        fr = padded[f * cfg.hop_length : f * cfg.hop_length + cfg.n_fft] * window
        s = np.fft.rfft(fr)
        spec[f] = np.abs(s) ** 2
    fb = mel_filterbank(cfg.num_mel_bins, cfg.n_fft // 2 + 1, cfg.sample_rate, cfg.n_fft).astype(np.float64)
    mel = np.log(spec @ fb + cfg.log_zero_guard)
    mean = mel.mean(axis=0, keepdims=True)
    std = mel.std(axis=0, ddof=1, keepdims=True)
    return ((mel - mean) / (std + 1e-5)).astype(np.float32)
