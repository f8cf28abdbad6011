"""Pyannote segmentation-3.0 family: SincNet→BiLSTM→powerset, VAD pipeline."""

from .model import (  # noqa: F401
    SEGMENTATION_30,
    PyannoteSegmentation,
    PyannoteVAD,
    SegmentationConfig,
    config_tiny,
    powerset_to_speakers,
)
