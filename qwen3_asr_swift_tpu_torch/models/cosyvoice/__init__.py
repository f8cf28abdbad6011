"""CosyVoice3 TTS on one device: LLM → flow-matching DiT → HiFT vocoder,
voice cloning, dialogue."""

from .dit import CosyDiTConfig, CosyFlowConfig, dit_forward, flow_generate  # noqa: F401
from .hift import CosyHiFTConfig, hift_generate  # noqa: F401
from .model import (  # noqa: F401
    CONFIG_05B,
    CosyVoiceConfig,
    CosyVoiceTTS,
    Voice,
    config_tiny,
    parse_dialogue,
)
