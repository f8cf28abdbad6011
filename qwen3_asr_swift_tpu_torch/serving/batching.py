"""The port's copy of ``ContinuousBatcher`` from
``qwen3_asr_swift_tpu/serving/batching.py`` (``TTSBatcher`` waits for a TTS family).

Continuous batching scheduler for ASR/TTS serving.

NEW subsystem (no reference counterpart): the reference server holds one
model instance and serves one request at a time
(reference: Sources/AudioServer/AudioServer.swift:182-237). On TPU,
per-token cost is dominated by weight reads, so batching N requests into
one decode multiplies throughput ~N× — this scheduler packs concurrent
requests into shared compiled programs:

- requests enqueue with a future; a dispatcher thread drains the queue;
- a batch window (max_batch, max_wait_ms) groups compatible requests
  (same audio bucket ⇒ same compiled program — the bucketing from
  models/*); each group runs as ONE ``transcribe_batch`` call;
- results resolve per-request futures.

This is deliberately a simple slot-batcher (prefill+decode run per group)
rather than token-level interleaving: ASR decode lengths are short
(~100 tokens) and homogeneous, where group batching captures nearly all
of the win without cross-request KV paging.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ..core.logging import serving as log


@dataclasses.dataclass
class _Request:
    audio: np.ndarray
    sample_rate: int
    kwargs: dict
    future: Future
    enqueued_at: float


class ContinuousBatcher:
    """Groups concurrent transcription requests into batched model calls.

    ``workers`` > 1 runs several dispatcher threads over the shared queue:
    while one group's batch computes on device, another group stages its
    audio over the host→device link, so a long-bucket group no longer
    stalls the queue behind it and host I/O pipelines against device
    compute (the device itself serializes the compute; JAX dispatch is
    thread-safe). On a dp-sharded model each ``transcribe_batch`` call
    already splits its batch across the dp rows (models/qwen3_asr), so
    the batcher needs no dp routing of its own — size ``max_batch`` to
    dp × per-device batch."""

    def __init__(self, model, max_batch: int = 16, max_wait_ms: float = 30.0,
                 group_key: Optional[Callable[[_Request], Any]] = None,
                 workers: int = 2, gate_slots: int = 2,
                 bulk_nice: Optional[int] = None):
        self.model = model
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        # Optional OS-priority demotion for the bulk worker threads
        # (dispatch.BULK_NICE): on a core-starved serving host, batch
        # staging otherwise time-slices against the latency-sensitive
        # handler threads (WS realtime frames, new-request parsing).
        # Off by default — it only matters under CPU saturation.
        self._bulk_nice = bulk_nice
        # Attach a priority dispatch gate to the model (if it supports one
        # and none is attached yet): decode chunks from different groups
        # then interleave on the device at chunk granularity, and a newly
        # arriving request's first chunk rides the latency lane instead of
        # waiting out whole queued generates (serving/dispatch.py).
        self.gate = None
        if gate_slots and getattr(model, "dispatch_gate", "absent") is None:
            from .dispatch import DispatchGate

            self.gate = model.dispatch_gate = DispatchGate(slots=gate_slots)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._group_key = group_key or self._default_group_key
        self._stats_lock = threading.Lock()
        self.requests_served = 0
        self.batches_run = 0
        self._stop = False
        self._threads = [
            threading.Thread(target=self._run, daemon=True, name=f"batcher-{i}")
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    def _default_group_key(self, req: _Request):
        # same kwargs → same prompt shape / sampling program
        return tuple(sorted(req.kwargs.items()))

    def submit(self, audio: np.ndarray, sample_rate: int = 16000, **kwargs) -> Future:
        fut: Future = Future()
        self._queue.put(_Request(audio, sample_rate, kwargs, fut, time.perf_counter()))
        return fut

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16000, timeout: float = 300.0, **kwargs):
        return self.submit(audio, sample_rate, **kwargs).result(timeout=timeout)

    def shutdown(self):
        self._stop = True
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join(timeout=5)
        # fail queued-but-unserved requests instead of leaving their
        # futures pending forever (callers block on fut.result)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("batcher shut down"))

    # ------------------------------------------------------------------ #

    def _collect_batch(self) -> List[_Request]:
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        key = self._group_key(first)
        leftovers: List[_Request] = []
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self._queue.put(None)  # re-queue another worker's shutdown sentinel
                break
            if self._group_key(req) == key:
                batch.append(req)
            else:
                leftovers.append(req)
        for req in leftovers:  # different shape → next batch
            self._queue.put(req)
        return batch

    def _run(self):
        if self._bulk_nice is not None:
            from .dispatch import set_thread_nice

            set_thread_nice(self._bulk_nice)
        while not self._stop:
            batch = self._collect_batch()
            if not batch:
                continue
            try:
                # resample per-request rates to a common one on the host
                audios = []
                for r in batch:
                    a = r.audio
                    if r.sample_rate != 16000:
                        from ..audio.resample import resample

                        a = resample(a.astype(np.float32), r.sample_rate, 16000)
                    audios.append(a)
                t0 = time.perf_counter()
                results = self.model.transcribe_batch(audios, sample_rate=16000, **batch[0].kwargs)
                dt = time.perf_counter() - t0
                with self._stats_lock:
                    self.requests_served += len(batch)
                    self.batches_run += 1
                log.debug("batch of %d in %.0f ms", len(batch), dt * 1e3)
                for r, res in zip(batch, results):
                    r.future.set_result(res)
            except Exception as e:  # noqa: BLE001 — propagate to callers
                log.exception("batch failed")
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    @property
    def stats(self) -> dict:
        with self._stats_lock:
            out = {
                "requests_served": self.requests_served,
                "batches_run": self.batches_run,
                "mean_batch_size": self.requests_served / max(1, self.batches_run),
            }
        if self.gate is not None:
            out["dispatch_gate"] = self.gate.stats
        return out
