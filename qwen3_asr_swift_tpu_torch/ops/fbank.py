"""Kaldi-style log-mel filterbank features — port of
``qwen3_asr_swift_tpu/ops/fbank.py``.

Kaldi semantics: 25 ms frames at a 10 ms hop, snip-edges; per frame the
DC offset removed, pre-emphasis 0.97 (edge duplicated), the povey window
(hann^0.85); a 512-point DFT as two matmuls, the power spectrum, a
triangular HTK-mel filterbank with no area normalisation, log(max(x,
eps)). The filterbank and DFT bases are the reference's numpy functions,
copied; the frames go through torch on the audio's device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def hz_to_mel_htk(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def kaldi_mel_banks(num_bins: int = 80, n_fft: int = 512, sample_rate: int = 16000,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """[n_fft/2+1, num_bins] triangular filters on the HTK mel scale
    (Kaldi convention: bins exclude the Nyquist term handling differences;
    filters unnormalized)."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.arange(n_freqs) * sample_rate / n_fft
    mel_lo, mel_hi = hz_to_mel_htk(low_freq), hz_to_mel_htk(high_freq)
    mel_pts = np.linspace(mel_lo, mel_hi, num_bins + 2)
    fmel = hz_to_mel_htk(fft_freqs)
    fb = np.zeros((n_freqs, num_bins))
    for m in range(num_bins):
        left, center, right = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        up = (fmel - left) / (center - left)
        down = (right - fmel) / (right - center)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _povey_dft(frame_len: int = 400, n_fft: int = 512, preemph: float = 0.97
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) DFT bases with the povey window folded in; pre-emphasis
    is handled per frame before windowing (not foldable), so these carry
    the window only."""
    n = np.arange(frame_len, dtype=np.float64)
    povey = (0.5 - 0.5 * np.cos(2 * np.pi * n / (frame_len - 1))) ** 0.85
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    phase = 2 * np.pi * np.outer(n, k) / n_fft
    return (
        (povey[:, None] * np.cos(phase)).astype(np.float32),
        (povey[:, None] * -np.sin(phase)).astype(np.float32),
    )


def kaldi_fbank(audio: torch.Tensor, num_bins: int = 80, frame_len: int = 400, hop: int = 160,
                n_fft: int = 512, preemph: float = 0.97, remove_dc: bool = True,
                sample_rate: int = 16000) -> torch.Tensor:
    """audio float [..., T] (raw [-1, 1]; ×32768 first for Kaldi's scale)
    → log-mel [..., n_frames, num_bins] (snip-edges)."""
    t = audio.shape[-1]
    n_frames = max(0, 1 + (t - frame_len) // hop)
    idx = (torch.arange(n_frames, device=audio.device)[:, None] * hop
           + torch.arange(frame_len, device=audio.device)[None, :])
    frames = audio[..., idx]
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemph > 0:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemph * shifted
    cos_m, sin_m = (torch.from_numpy(m).to(audio.device)
                    for m in _povey_dft(frame_len, n_fft, preemph))
    re, im = frames @ cos_m, frames @ sin_m
    power = re * re + im * im
    fb = torch.from_numpy(kaldi_mel_banks(num_bins, n_fft, sample_rate)).to(audio.device)
    return torch.log(torch.clamp(power @ fb, min=1.1921e-7))  # Kaldi epsilon (float32 eps)
