"""Audio ring buffers for streaming capture/playback paths.

TPU-native analog of the reference's ring buffers
(reference: Sources/AudioCommon/AudioRingBuffer.swift,
AudioSampleRingBuffer). Thread-safe via a single lock; used by the serving
layer and the voice-pipeline bindings to smooth producer/consumer rates.
"""

from __future__ import annotations

import threading

import numpy as np


class AudioRingBuffer:
    """Fixed-capacity float32 sample ring with overwrite-oldest semantics."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._buf = np.zeros(capacity, dtype=np.float32)
        self._capacity = capacity
        self._read = 0   # absolute sample index of read cursor
        self._write = 0  # absolute sample index of write cursor
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def available(self) -> int:
        with self._lock:
            return self._write - self._read

    def write(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, dtype=np.float32)
        with self._lock:
            n = len(samples)
            if n >= self._capacity:
                # Only the final window survives.
                samples = samples[-self._capacity :]
                n = len(samples)
            start = self._write % self._capacity
            first = min(n, self._capacity - start)
            self._buf[start : start + first] = samples[:first]
            if n > first:
                self._buf[: n - first] = samples[first:]
            self._write += n
            # Overwrite-oldest: advance read cursor if we lapped it.
            if self._write - self._read > self._capacity:
                self._read = self._write - self._capacity

    def read(self, count: int) -> np.ndarray:
        """Read up to ``count`` samples (fewer if not available)."""
        with self._lock:
            n = min(count, self._write - self._read)
            start = self._read % self._capacity
            first = min(n, self._capacity - start)
            out = np.empty(n, dtype=np.float32)
            out[:first] = self._buf[start : start + first]
            if n > first:
                out[first:] = self._buf[: n - first]
            self._read += n
            return out

    def peek_last(self, count: int) -> np.ndarray:
        """Non-destructively view the most recent ``count`` samples
        (the pre-speech ring-buffer pattern of the C++ voice engine)."""
        with self._lock:
            n = min(count, self._write - self._read, self._capacity)
            end = self._write % self._capacity
            start = (end - n) % self._capacity
            if n == 0:
                return np.empty(0, dtype=np.float32)
            if start < end:
                return self._buf[start:end].copy()
            return np.concatenate([self._buf[start:], self._buf[:end]])

    def clear(self) -> None:
        with self._lock:
            self._read = self._write
