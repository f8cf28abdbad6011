"""Qwen3-ASR: batched transcription, the forced aligner and streaming ASR
on one device."""

from .config import (CONFIG_LARGE, CONFIG_SMALL, AudioEncoderConfig,  # noqa: F401
                     Qwen3ASRConfig, TextDecoderConfig, config_tiny, detect_config)
from .model import Qwen3ASR  # noqa: F401
from .aligner import Qwen3ForcedAligner, enforce_monotonicity, slot_text  # noqa: F401
from .streaming import StreamingASR, StreamingASRConfig, longest_common_prefix  # noqa: F401
