"""The port's copy of ``SpeechRecognitionModel`` from
``qwen3_asr_swift_tpu/core/protocols.py``.
"""

from __future__ import annotations

import abc
from typing import Optional

import numpy as np

from .types import ModelMemoryStats, TranscriptionResult


class SpeechModel(abc.ABC):
    """Base: loadable, warmable, unloadable model."""

    @classmethod
    @abc.abstractmethod
    def from_pretrained(
        cls,
        model_id: str,
        cache_dir: Optional[str] = None,
        offline_mode: bool = False,
        progress_handler=None,
        **kwargs,
    ) -> "SpeechModel":
        """Download (or use cached) weights and build the model."""

    def warm_up(self) -> None:
        """Trigger compilation of the hot programs with tiny inputs."""

    def unload(self) -> None:
        """Drop device arrays; model must be reloaded before reuse."""

    def memory_stats(self) -> ModelMemoryStats:
        return ModelMemoryStats(parameter_bytes=0)

    @property
    def is_loaded(self) -> bool:
        return True


class SpeechRecognitionModel(SpeechModel):
    """Batch ASR (reference: SpeechRecognitionModel protocol)."""

    @abc.abstractmethod
    def transcribe(
        self,
        audio: np.ndarray,
        sample_rate: int = 16000,
        language: Optional[str] = None,
        **kwargs,
    ) -> TranscriptionResult:
        ...
