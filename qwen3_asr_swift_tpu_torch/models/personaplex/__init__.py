"""PersonaPlex speech-to-speech (Mimi codec + temporal LM + depformer) —
port of ``qwen3_asr_swift_tpu/models/personaplex``."""

from .mimi import MimiConfig, init_mimi_params, mimi_decode, mimi_encode  # noqa: F401
from .model import (  # noqa: F401
    CONFIG_7B,
    PersonaPlex,
    PersonaPlexConfig,
    PersonaSampling,
    config_tiny,
)
