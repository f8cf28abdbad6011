"""Silero VAD v5: batch + streaming voice activity detection."""

from .model import SileroVAD, VADConfig, binarize, scan_probs  # noqa: F401
from .streaming import StreamingVADProcessor, VADEvent, VADEventType  # noqa: F401
