"""Kokoro-82M TTS (StyleTTS2-derived) + multilingual phonemizer."""

from .model import CONFIG_82M, KokoroConfig, KokoroTTS, config_tiny, trim_and_fade  # noqa: F401
from .phonemizer import phonemize, phonemes_to_ids, SYMBOLS, VOCAB_SIZE  # noqa: F401
