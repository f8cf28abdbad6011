"""Streaming VAD event processor: hysteresis + duration filtering — a copy
of ``qwen3_asr_swift_tpu/models/silero_vad/streaming.py``.

TPU-native analog of the reference's 4-state machine
(reference: Sources/SpeechVAD/StreamingVADProcessor.swift:39-209):
silence → pendingSpeech → speech → pendingSilence, with
min-speech/min-silence duration filtering, event emission, and flush.
Host-side control logic (the per-chunk probability comes from the jitted
VAD); states are explicit values so the processor is trivially testable.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from ...core.types import SpeechSegment
from .model import CHUNK, SAMPLE_RATE, SileroVAD, VADConfig


class VADEventType(enum.Enum):
    SPEECH_STARTED = "speech_started"
    SPEECH_ENDED = "speech_ended"


@dataclasses.dataclass(frozen=True)
class VADEvent:
    type: VADEventType
    time: float
    segment: Optional[SpeechSegment] = None


class _State(enum.Enum):
    SILENCE = 0
    PENDING_SPEECH = 1
    SPEECH = 2
    PENDING_SILENCE = 3


class StreamingVADProcessor:
    """Buffers arbitrary sample pushes into VAD chunks, applies hysteresis
    with duration confirmation, and emits start/end events."""

    def __init__(self, vad: SileroVAD, config: VADConfig = VADConfig()):
        self.vad = vad
        self.cfg = config
        self.chunk_duration = CHUNK / SAMPLE_RATE
        self.reset()

    def reset(self) -> None:
        self._buffer = np.empty(0, np.float32)
        self._stream = self.vad.new_stream()
        self._time = 0.0
        self._state = _State.SILENCE
        self._speech_start = 0.0
        self._silence_start = 0.0

    def process(self, samples: np.ndarray) -> List[VADEvent]:
        """Push samples; returns confirmed events."""
        self._buffer = np.concatenate([self._buffer, samples.astype(np.float32)])
        events: List[VADEvent] = []
        while len(self._buffer) >= CHUNK:
            chunk, self._buffer = self._buffer[:CHUNK], self._buffer[CHUNK:]
            self._stream, prob = self.vad.process_chunk(self._stream, chunk)
            events.extend(self._step(prob, self._time))
            self._time += self.chunk_duration
        return events

    def flush(self) -> List[VADEvent]:
        """Process the remaining partial chunk and close any open segment
        (reference: StreamingVADProcessor.flush, :100-160)."""
        events: List[VADEvent] = []
        if len(self._buffer) > 0:
            chunk = np.pad(self._buffer, (0, CHUNK - len(self._buffer)))
            self._buffer = np.empty(0, np.float32)
            self._stream, prob = self.vad.process_chunk(self._stream, chunk)
            events.extend(self._step(prob, self._time))
            self._time += self.chunk_duration

        end = self._time
        if self._state == _State.PENDING_SPEECH:
            if end - self._speech_start >= self.cfg.min_speech_duration:
                events.append(VADEvent(VADEventType.SPEECH_STARTED, self._speech_start))
                events.append(VADEvent(VADEventType.SPEECH_ENDED, end,
                                       SpeechSegment(self._speech_start, end)))
        elif self._state == _State.SPEECH:
            events.append(VADEvent(VADEventType.SPEECH_ENDED, end,
                                   SpeechSegment(self._speech_start, end)))
        elif self._state == _State.PENDING_SILENCE:
            events.append(VADEvent(VADEventType.SPEECH_ENDED, self._silence_start,
                                   SpeechSegment(self._speech_start, self._silence_start)))
        self._state = _State.SILENCE
        return events

    # -- state machine (reference: StreamingVADProcessor.processProb) -------

    def _step(self, prob: float, t: float) -> List[VADEvent]:
        cfg = self.cfg
        next_t = t + self.chunk_duration
        events: List[VADEvent] = []

        if self._state == _State.SILENCE:
            if prob >= cfg.onset:
                self._speech_start = t
                self._state = _State.PENDING_SPEECH
                # immediate confirmation if min duration is ≤ one chunk
                if next_t - t >= cfg.min_speech_duration:
                    self._state = _State.SPEECH
                    events.append(VADEvent(VADEventType.SPEECH_STARTED, t))
        elif self._state == _State.PENDING_SPEECH:
            if prob < cfg.offset:
                self._state = _State.SILENCE
            elif next_t - self._speech_start >= cfg.min_speech_duration:
                self._state = _State.SPEECH
                events.append(VADEvent(VADEventType.SPEECH_STARTED, self._speech_start))
        elif self._state == _State.SPEECH:
            if prob < cfg.offset:
                self._silence_start = t
                self._state = _State.PENDING_SILENCE
        elif self._state == _State.PENDING_SILENCE:
            if prob >= cfg.onset:
                self._state = _State.SPEECH
            elif next_t - self._silence_start >= cfg.min_silence_duration:
                self._state = _State.SILENCE
                events.append(VADEvent(
                    VADEventType.SPEECH_ENDED, self._silence_start,
                    SpeechSegment(self._speech_start, self._silence_start),
                ))
        return events
