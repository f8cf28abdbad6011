"""Omnilingual ASR (wav2vec2 + CTC, 1,672 languages)."""

from .model import (  # noqa: F401
    CONFIG_1B,
    CONFIG_300M,
    OmniConfig,
    OmnilingualASR,
    config_tiny,
    ctc_greedy_collapse,
)
