"""Speech enhancement (DeepFilterNet3) — port of
``qwen3_asr_swift_tpu/models/enhancement``."""

from .dfn3 import init_dfn3_params  # noqa: F401
from .model import SpeechEnhancer, StreamingEnhancer, erb_filterbank  # noqa: F401
