"""Qwen3-TTS: talker + code predictor + speech-tokenizer decoder on one device."""

from .config import (CONFIG_06B, CONFIG_17B, CodecTokens, Qwen3TTSConfig,  # noqa: F401
                     config_tiny)
from .codec import CodecDecoder, codec_decode, init_codec_params  # noqa: F401
from .model import Qwen3TTS, TTSSamplingConfig  # noqa: F401
