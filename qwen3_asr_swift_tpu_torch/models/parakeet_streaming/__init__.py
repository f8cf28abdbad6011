"""Cache-aware streaming RNNT ASR (Parakeet-EOU 120M / Nemotron 0.6B)."""

from .config import (  # noqa: F401
    CONFIG_EOU_120M,
    CONFIG_NEMOTRON_06B,
    StreamingConformerConfig,
    config_tiny,
)
from .encoder import EncoderCaches, encode_chunk, init_caches, streaming_log_mel  # noqa: F401
from .model import (  # noqa: F401
    NemotronStreamingASR,
    ParakeetStreamingASR,
    StreamingResult,
    StreamingSession,
    rnnt_chunk_decode,
)
