"""VoxCPM2: MiniCPM4 dual-LM + FSQ + local-DiT flow matching + AudioVAE, 48 kHz."""

from .model import (  # noqa: F401
    CONFIG_2B,
    VoxCPM2Config,
    VoxCPM2TTS,
    config_tiny,
)
