"""Paced streaming audio sink.

TPU-native analog of the reference's StreamingAudioPlayer (reference:
Sources/AudioCommon/StreamingAudioPlayer.swift — AVAudioEngine playback
with a pre-buffer threshold before starting). A TPU server has no audio
device; the equivalent need is pacing: realtime endpoints must emit PCM
at playback speed, and voice-agent tests need underrun accounting. This
sink accepts chunks as they are synthesized, holds them until
``prebuffer_s`` is queued, then releases frames paced to the sample rate
(or as fast as asked when ``realtime=False``).
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

import numpy as np


class StreamingAudioPlayer:
    """Pre-buffered, paced PCM release (reference: StreamingAudioPlayer)."""

    def __init__(self, sample_rate: int = 24000, prebuffer_s: float = 0.3,
                 realtime: bool = True):
        self.sample_rate = sample_rate
        self.prebuffer_s = prebuffer_s
        self.realtime = realtime
        self._buf = np.zeros(0, np.float32)
        self._lock = threading.Lock()
        self._done = False
        self._started = False
        self._clock: Optional[float] = None
        self._released = 0
        self.underruns = 0

    # -- producer side -----------------------------------------------------

    def push(self, samples: np.ndarray) -> None:
        with self._lock:
            self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
            if not self._started and len(self._buf) >= self.prebuffer_s * self.sample_rate:
                self._started = True

    def finish(self) -> None:
        """Producer signals end-of-stream; remaining audio drains."""
        with self._lock:
            self._done = True
            self._started = True  # whatever is buffered plays out

    # -- consumer side -----------------------------------------------------

    @property
    def buffered_s(self) -> float:
        with self._lock:
            return len(self._buf) / self.sample_rate

    @property
    def is_playing(self) -> bool:
        with self._lock:
            return self._started and (len(self._buf) > 0 or not self._done)

    def read(self, n_samples: int, timeout: float = 5.0) -> np.ndarray:
        """Blocking read of up to n_samples. Returns fewer only at end of
        stream. Counts an underrun when playback has started but the
        buffer can't cover the request."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if self._started:
                    if len(self._buf) >= n_samples or self._done:
                        take = min(n_samples, len(self._buf))
                        out, self._buf = self._buf[:take], self._buf[take:]
                        if take < n_samples and not self._done:
                            self.underruns += 1
                        self._released += take
                        break
            if time.monotonic() > deadline:
                with self._lock:
                    self.underruns += 1
                return np.zeros(0, np.float32)
            time.sleep(0.002)
        if self.realtime:
            if self._clock is None:
                self._clock = time.monotonic()
            due = self._clock + (self._released - len(out)) / self.sample_rate
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        return out

    def frames(self, frame_samples: int = 1024, timeout: float = 5.0) -> Iterator[np.ndarray]:
        """Generator of paced frames until the stream drains."""
        while True:
            out = self.read(frame_samples, timeout)
            if len(out) == 0:
                with self._lock:
                    if self._done and len(self._buf) == 0:
                        return
                continue
            yield out
            with self._lock:
                if self._done and len(self._buf) == 0:
                    return
