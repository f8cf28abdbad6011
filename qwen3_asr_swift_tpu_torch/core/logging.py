"""The port's copy of ``qwen3_asr_swift_tpu/core/logging.py`` (``profile_trace``,
which imports jax, is left out).

Structured logging categories.

TPU-native analog of the reference's os.Logger categories
(reference: Sources/AudioCommon/Logging.swift:4-13 — ModelLoading,
Inference, Download, Pipeline).
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

_FMT = "%(asctime)s %(name)s %(levelname)s %(message)s"
_LEVEL = os.environ.get("SPEECH_LOG_LEVEL", "INFO").upper()
if _LEVEL not in ("CRITICAL", "ERROR", "WARNING", "INFO", "DEBUG", "NOTSET"):
    _LEVEL = "INFO"  # a typo'd env var must not make the package unimportable

# only configure logging when the host application hasn't — importing a
# library must not override an embedding app's root logger setup
if not logging.getLogger().handlers:
    logging.basicConfig(level=_LEVEL, format=_FMT)


def get_logger(category: str) -> logging.Logger:
    return logging.getLogger(f"speech.{category}")


model_loading = get_logger("ModelLoading")
inference = get_logger("Inference")
download = get_logger("Download")
pipeline = get_logger("Pipeline")
serving = get_logger("Serving")


@contextmanager
def log_stage(logger: logging.Logger, stage: str):
    """Per-stage wall-clock timing, the reference's CFAbsoluteTime pattern
    (reference: Sources/ParakeetASR/ParakeetASR.swift:99-131)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.debug("%s took %.1f ms", stage, (time.perf_counter() - t0) * 1e3)
