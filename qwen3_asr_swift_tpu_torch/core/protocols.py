"""The port's copy of the capability interfaces it implements, from
``qwen3_asr_swift_tpu/core/protocols.py``: ``SpeechRecognitionModel``,
``SpeechGenerationModel``, ``SpeechToSpeechModel``,
``VoiceActivityDetectionModel``, ``StreamingVADProvider``,
``SpeechEnhancementModel`` and ``ForcedAlignmentModel``.
"""

from __future__ import annotations

import abc
from typing import Any, Iterator, Optional, Sequence

import numpy as np

from .types import AlignedWord, AudioChunk, ModelMemoryStats, SpeechSegment, TranscriptionResult


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


class SpeechGenerationModel(SpeechModel):
    """TTS (reference: SpeechGenerationModel)."""

    @abc.abstractmethod
    def synthesize(self, text: str, voice: Optional[str] = None, **kwargs) -> AudioChunk:
        ...

    def synthesize_stream(self, text: str, voice: Optional[str] = None, **kwargs) -> Iterator[AudioChunk]:
        yield self.synthesize(text, voice=voice, **kwargs)


class VoiceActivityDetectionModel(SpeechModel):
    """Batch VAD (reference: VoiceActivityDetectionModel)."""

    @abc.abstractmethod
    def detect_speech(self, audio: np.ndarray, sample_rate: int = 16000, **kwargs) -> Sequence[SpeechSegment]:
        ...

    @abc.abstractmethod
    def speech_probabilities(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        """Per-chunk speech probabilities."""


class StreamingVADProvider(abc.ABC):
    """Streaming VAD with carried state (reference: StreamingVADProvider)."""

    @abc.abstractmethod
    def new_stream(self) -> Any:
        ...

    @abc.abstractmethod
    def process_chunk(self, state: Any, samples: np.ndarray) -> tuple[Any, float]:
        """Returns (new_state, speech probability for this chunk)."""

    @property
    @abc.abstractmethod
    def chunk_size(self) -> int:
        """Samples per VAD step at 16 kHz."""


class SpeechToSpeechModel(SpeechModel):
    """Full-duplex speech-to-speech (reference: SpeechToSpeechModel)."""

    @abc.abstractmethod
    def respond(self, audio: np.ndarray, sample_rate: int = 16000, **kwargs) -> AudioChunk:
        ...


class SpeechEnhancementModel(SpeechModel):
    """Denoising / enhancement (reference: SpeechEnhancementModel)."""

    @abc.abstractmethod
    def enhance(self, audio: np.ndarray, sample_rate: int) -> AudioChunk:
        ...


class ForcedAlignmentModel(SpeechModel):
    """Text-audio forced alignment (reference: ForcedAlignmentModel)."""

    @abc.abstractmethod
    def align(self, audio: np.ndarray, text: str, sample_rate: int = 16000, **kwargs) -> Sequence[AlignedWord]:
        ...
