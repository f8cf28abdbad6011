"""Music source separation (Open-Unmix + Wiener)."""

from .model import STEMS, SourceSeparator, signal_to_distortion_ratio  # noqa: F401
