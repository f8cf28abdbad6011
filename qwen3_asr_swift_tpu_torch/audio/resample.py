"""The port's copy of the host resampler of
``qwen3_asr_swift_tpu/audio/resample.py`` (the jax path is left out).

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
