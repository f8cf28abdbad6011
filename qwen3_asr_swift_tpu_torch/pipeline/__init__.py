"""Voice-agent pipeline: the C++ engine and its Python bindings — port of
``qwen3_asr_swift_tpu/pipeline``."""

from .engine import (  # noqa: F401
    PipelineConfig,
    PipelineEvent,
    PipelineEventType,
    PipelineState,
    VoicePipeline,
    ensure_library,
    tool_call,
)
