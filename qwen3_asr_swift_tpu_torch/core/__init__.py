"""Core foundation of the port: the value types and capability interfaces
copied from the JAX package, weights carried across from its parameter
tree, the local checkpoint cache and the memory tiers."""

from .types import (  # noqa: F401
    AlignedWord,
    AudioChunk,
    DiarizedSegment,
    ModelMemoryStats,
    PartialTranscription,
    SpeechSegment,
    TranscriptionResult,
    WordConfidence,
)
from .protocols import (  # noqa: F401
    ForcedAlignmentModel,
    PipelineLLM,
    SourceSeparationModel,
    SpeakerDiarizationModel,
    SpeakerEmbeddingModel,
    SpeechEnhancementModel,
    SpeechGenerationModel,
    SpeechModel,
    SpeechRecognitionModel,
    SpeechToSpeechModel,
    StreamingRecognitionModel,
    StreamingVADProvider,
    TranslationModel,
    VoiceActivityDetectionModel,
    WakeWordModel,
)
