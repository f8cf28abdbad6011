"""Qwen3-ASR: batched transcription on one device."""

from .config import (CONFIG_LARGE, CONFIG_SMALL, AudioEncoderConfig,  # noqa: F401
                     Qwen3ASRConfig, TextDecoderConfig, config_tiny)
from .model import Qwen3ASR  # noqa: F401
