"""VibeVoice TTS on one device: LM + DPM-Solver diffusion head over σ-VAE
latents."""

from .model import (  # noqa: F401
    CONFIG_05B,
    VibeVoiceConfig,
    VibeVoiceTTS,
    config_tiny,
)
