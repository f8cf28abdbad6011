"""The port's copy of ``qwen3_asr_swift_tpu/core/logging.py``;
``profile_trace`` captures the block with ``torch.profiler`` in place of
``jax.profiler``, with the program's spans in it.

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

from . import trace

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


@contextmanager
def profile_trace(trace_dir: str | None = None, annotate: str = ""):
    """Capture a device profile around a block with ``torch.profiler`` (CPU
    activity, and CUDA activity when a card is present), the block inside
    ``record_function(annotate)``, and export it as a Chrome trace
    (``<pid>.<ns>.pt.trace.json``, viewed in Perfetto or
    ``chrome://tracing``) into ``trace_dir`` (default: ``speech_trace``
    under the temporary directory). The program's spans (``core/trace.py``)
    are recorded and put into the trace as ranges for the block, and the
    tracer's state is restored after it. Also logs wall time like
    :func:`log_stage`.

    Usage::

        with profile_trace("/tmp/trace", "asr-batch"):
            model.transcribe_batch(clips)
    """
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "speech_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    try:
        with profile(activities=activities) as prof, trace.annotating():
            if annotate:
                with record_function(annotate):
                    yield
            else:
                yield
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))
    finally:
        inference.info("profile %s: %.1f ms → %s", annotate or "block",
                       (time.perf_counter() - t0) * 1e3, trace_dir)
