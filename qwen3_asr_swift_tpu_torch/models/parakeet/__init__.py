"""Parakeet-TDT 0.6B: FastConformer encoder + on-device TDT decode."""

from .config import CONFIG_06B, ParakeetConfig, config_tiny  # noqa: F401
from .model import ParakeetASR, tdt_decode  # noqa: F401
