"""The port's copy of the value types it uses from
``qwen3_asr_swift_tpu/core/types.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class WordConfidence:
    """Per-word confidence from decoder log-probs."""

    word: str
    confidence: float  # exp(mean token log-prob), in [0, 1]
    start: Optional[float] = None  # seconds
    end: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class TranscriptionResult:
    """Result of a (batch) transcription."""

    text: str
    language: Optional[str] = None
    confidence: Optional[float] = None
    words: Sequence[WordConfidence] = ()
    duration: Optional[float] = None  # audio seconds
    processing_time: Optional[float] = None  # wall seconds

    @property
    def rtf(self) -> Optional[float]:
        if self.duration and self.processing_time:
            return self.processing_time / self.duration
        return None


@dataclasses.dataclass(frozen=True)
class ModelMemoryStats:
    """Model memory footprint report (reference: Protocols.swift:5-35)."""

    parameter_bytes: int
    buffer_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return self.parameter_bytes + self.buffer_bytes


def to_float32(samples: np.ndarray) -> np.ndarray:
    """Convert int16/int32/float64 PCM to float32 in [-1, 1]."""
    if samples.dtype == np.float32:
        return samples
    if samples.dtype == np.int16:
        return samples.astype(np.float32) / 32768.0
    if samples.dtype == np.int32:
        return samples.astype(np.float32) / 2147483648.0
    if samples.dtype == np.uint8:
        return (samples.astype(np.float32) - 128.0) / 128.0
    return samples.astype(np.float32)


def to_pcm16(samples: np.ndarray) -> np.ndarray:
    """Convert float32 [-1, 1] to int16 PCM with clipping."""
    clipped = np.clip(samples, -1.0, 1.0)
    return (clipped * 32767.0).astype(np.int16)
