"""The port's copy of the host resampler of
``qwen3_asr_swift_tpu/audio/resample.py``, and :func:`resample_torch`, the
counterpart of its ``resample_jax`` on the device.

Sample-rate conversion.

TPU-native analog of the reference's AVAudioConverter / sinc resampler
(reference: Sources/AudioCommon/AudioFileLoader.swift:159-180). Host path
uses scipy's polyphase resampler; the JAX path resamples in the Fourier
domain (rfft → spectrum truncate/pad → irfft), which jits quickly on every
backend and keeps long-audio pipelines on device. (A time-domain FIR
formulation was rejected: XLA CPU compiles long-kernel convolutions
pathologically slowly, and FFT resampling is equally accurate for the
band-limited speech signals handled here.)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device


def resample(samples: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Polyphase resample float32 mono audio (host, scipy)."""
    if from_rate == to_rate:
        return samples
    if from_rate <= 0 or to_rate <= 0:
        raise ValueError("sample rates must be positive")
    from scipy.signal import resample_poly

    g = math.gcd(from_rate, to_rate)
    up, down = to_rate // g, from_rate // g
    out = resample_poly(samples.astype(np.float64), up, down)
    return out.astype(np.float32)


def _fourier_resample(x: torch.Tensor, out_len: int) -> torch.Tensor:
    n = x.shape[-1]
    spec = torch.fft.rfft(x)
    n_out_bins = out_len // 2 + 1
    n_in_bins = spec.shape[-1]
    if n_out_bins <= n_in_bins:  # downsample: truncate spectrum
        spec = spec[..., :n_out_bins]
    else:  # upsample: zero-pad spectrum
        spec = torch.nn.functional.pad(spec, (0, n_out_bins - n_in_bins))
    out = torch.fft.irfft(spec, n=out_len)
    return out * (out_len / n)


def resample_torch(samples, from_rate: int, to_rate: int, num_taps: int = 0,
                   device="cuda") -> torch.Tensor:
    """Fourier-domain resampler on ``device`` (rfft → spectrum truncated or
    zero-padded → irfft scaled by out_len / n), fp32 ``[..., n]`` →
    ``[..., ceil(n * to_rate / from_rate)]``: ``resample_jax``'s function.

    ``num_taps`` is accepted for API compatibility and ignored.
    """
    x = torch.as_tensor(samples, dtype=torch.float32, device=resolve_device(device))
    if from_rate == to_rate:
        return x
    g = math.gcd(from_rate, to_rate)
    up, down = to_rate // g, from_rate // g
    out_len = int(np.ceil(x.shape[-1] * up / down))
    return _fourier_resample(x, out_len)
