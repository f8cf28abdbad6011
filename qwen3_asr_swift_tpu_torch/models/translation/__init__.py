"""MADLAD-400 translation (T5 encoder-decoder)."""

from .model import CONFIG_3B, MADLADTranslator, T5Config, config_tiny  # noqa: F401
