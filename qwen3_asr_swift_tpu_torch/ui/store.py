"""Observable transcription state for app frontends.

TPU-native analog of the reference's SpeechUI layer (reference:
Sources/SpeechUI/SpeechUI.swift — SwiftUI ``TranscriptionView`` backed by
a ``TranscriptionStore``). There is no UI toolkit on a TPU host; the
useful part is the store: a thread-safe accumulator of final segments +
the in-flight partial, with observer callbacks any frontend (terminal,
web socket, notebook) can subscribe to. Feed it from
``StreamingASR.push`` / ``ParakeetStreamingASR`` sessions or pipeline
events.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional


@dataclasses.dataclass(frozen=True)
class TranscriptSegment:
    text: str
    start: float
    end: float
    confidence: Optional[float] = None


class TranscriptionStore:
    """Thread-safe final-segments + live-partial state with observers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._segments: List[TranscriptSegment] = []
        self._partial: str = ""
        self._observers: List[Callable[["TranscriptionStore"], None]] = []
        self._started_at = time.monotonic()

    # -- mutation ---------------------------------------------------------

    def update_partial(self, text: str) -> None:
        with self._lock:
            self._partial = text
        self._notify()

    def commit(self, text: str, start: float = 0.0, end: float = 0.0,
               confidence: Optional[float] = None) -> None:
        # an empty final still ENDS the segment: the in-flight partial must
        # clear (otherwise a rejected/empty segment leaves a dead partial
        # on screen forever)
        with self._lock:
            if text:
                self._segments.append(TranscriptSegment(text, start, end, confidence))
            self._partial = ""
        self._notify()

    def ingest(self, event) -> None:
        """Feed a PartialTranscription (core.types) or a StreamingResult."""
        is_final = getattr(event, "is_final", False)
        text = getattr(event, "text", "")
        if is_final:
            self.commit(text,
                        getattr(event, "segment_start", 0.0),
                        getattr(event, "segment_end", 0.0),
                        getattr(event, "confidence", None))
        else:
            self.update_partial(text)

    def clear(self) -> None:
        with self._lock:
            self._segments = []
            self._partial = ""
        self._notify()

    # -- read -------------------------------------------------------------

    @property
    def segments(self) -> List[TranscriptSegment]:
        with self._lock:
            return list(self._segments)

    @property
    def partial(self) -> str:
        with self._lock:
            return self._partial

    @property
    def transcript(self) -> str:
        """All committed text plus the live partial."""
        with self._lock:
            parts = [s.text for s in self._segments]
            if self._partial:
                parts.append(self._partial)
            return " ".join(parts)

    # -- observers ----------------------------------------------------------

    def subscribe(self, fn: Callable[["TranscriptionStore"], None]) -> Callable[[], None]:
        """Register an observer; returns an unsubscribe callable."""
        with self._lock:
            self._observers.append(fn)

        def unsubscribe():
            with self._lock:
                if fn in self._observers:
                    self._observers.remove(fn)

        return unsubscribe

    def _notify(self) -> None:
        with self._lock:
            observers = list(self._observers)
        for fn in observers:
            fn(self)
