"""Streaming ASR: VAD-gated segmentation → per-segment transcription — a
copy of ``qwen3_asr_swift_tpu/models/qwen3_asr/streaming.py`` over the
port's ``Qwen3ASR`` and ``SileroVAD`` (each partial or final is one solo
``transcribe`` on the model's device).

TPU-native analog of the reference's StreamingASR composition
(reference: Sources/Qwen3ASR/StreamingASR.swift:60-262):
- a streaming VAD segments the input;
- within an active segment, partial transcripts are emitted every
  ``partial_interval`` seconds of new audio;
- segments exceeding ``max_segment_duration`` are force-split;
- finals are emitted when the VAD closes a segment;
- ``longest_common_prefix`` supports LocalAgreement-style UI smoothing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ...core.types import PartialTranscription
from ..silero_vad import SileroVAD, StreamingVADProcessor, VADConfig, VADEventType
from .model import Qwen3ASR


def longest_common_prefix(a: str, b: str) -> str:
    """Word-level common prefix (reference: StreamingASR.swift helper)."""
    wa, wb = a.split(), b.split()
    out = []
    for x, y in zip(wa, wb):
        if x != y:
            break
        out.append(x)
    return " ".join(out)


@dataclasses.dataclass(frozen=True)
class StreamingASRConfig:
    partial_interval: float = 1.0        # seconds of new audio between partials
    max_segment_duration: float = 30.0   # force-split beyond this
    language: Optional[str] = None
    max_tokens: int = 448
    vad: VADConfig = VADConfig()


class StreamingASR:
    """Composable VAD + ASR streaming pipeline (host orchestration; both
    models run their jitted programs)."""

    def __init__(self, asr: Qwen3ASR, vad: SileroVAD, config: StreamingASRConfig = StreamingASRConfig()):
        self.asr = asr
        self.cfg = config
        self._vad_proc = StreamingVADProcessor(vad, config.vad)
        self._sr = 16000
        self.reset()

    #: seconds of recent audio retained so a SPEECH_STARTED event whose
    #: timestamp lies in an earlier push (the VAD confirms onset only
    #: after min_speech_duration) can seed the segment from the true
    #: onset instead of clipping the first words
    PRE_ROLL_S = 2.0

    def reset(self) -> None:
        self._vad_proc.reset()
        self._segment_audio: Optional[np.ndarray] = None
        self._segment_start = 0.0
        self._since_partial = 0.0
        self._stream_time = 0.0
        self._recent = np.empty(0, np.float32)  # ends at the current push's start
        self._recent_t0 = 0.0

    def push(self, samples: np.ndarray, sample_rate: int = 16000) -> List[PartialTranscription]:
        """Feed audio, get partial/final transcription events."""
        if sample_rate != self._sr:
            from ...audio.resample import resample

            samples = resample(samples.astype(np.float32), sample_rate, self._sr)
        samples = samples.astype(np.float32)
        out: List[PartialTranscription] = []

        events = self._vad_proc.process(samples)
        chunk_t0 = self._stream_time
        self._stream_time += len(samples) / self._sr

        for ev in events:
            if ev.type == VADEventType.SPEECH_STARTED:
                self._segment_start = ev.time
                # seed with pre-roll from the true onset (possibly several
                # pushes back) up to this push's start
                off = int((ev.time - self._recent_t0) * self._sr)
                self._segment_audio = np.asarray(
                    self._recent[max(0, off):], np.float32)
            elif ev.type == VADEventType.SPEECH_ENDED and self._segment_audio is not None:
                seg = ev.segment
                audio = self._slice_stream(samples, chunk_t0, self._segment_start, seg.end)
                out.append(self._emit(audio, self._segment_start, seg.end, final=True))
                self._segment_audio = None
                self._since_partial = 0.0

        if self._segment_audio is not None:
            # still inside speech: accumulate and maybe emit a partial
            self._segment_audio = np.concatenate([self._segment_audio, samples])
            self._since_partial += len(samples) / self._sr
            seg_dur = len(self._segment_audio) / self._sr

            if seg_dur >= self.cfg.max_segment_duration:
                # force split (reference: StreamingASR force-split path)
                end_t = self._segment_start + seg_dur
                out.append(self._emit(self._segment_audio, self._segment_start, end_t, final=True))
                self._segment_start = end_t
                self._segment_audio = np.empty(0, np.float32)
                self._since_partial = 0.0
            elif self._since_partial >= self.cfg.partial_interval and seg_dur > 0.2:
                end_t = self._segment_start + seg_dur
                out.append(self._emit(self._segment_audio, self._segment_start, end_t, final=False))
                self._since_partial = 0.0

        # roll the onset pre-roll buffer forward to the end of this push
        keep = int(self.PRE_ROLL_S * self._sr)
        self._recent = np.concatenate([self._recent, samples])[-keep:]
        self._recent_t0 = self._stream_time - len(self._recent) / self._sr
        return out

    def finish(self) -> List[PartialTranscription]:
        out: List[PartialTranscription] = []
        events = self._vad_proc.flush()
        for ev in events:
            if ev.type == VADEventType.SPEECH_ENDED and self._segment_audio is not None:
                out.append(self._emit(self._segment_audio, self._segment_start, ev.segment.end, final=True))
                self._segment_audio = None
        if self._segment_audio is not None and len(self._segment_audio) > 0.2 * self._sr:
            end_t = self._segment_start + len(self._segment_audio) / self._sr
            out.append(self._emit(self._segment_audio, self._segment_start, end_t, final=True))
            self._segment_audio = None
        return out

    # ------------------------------------------------------------------ #

    def _slice_stream(self, latest: np.ndarray, chunk_t0: float, start: float, end: float) -> np.ndarray:
        """Audio for [start, end): the accumulated segment PLUS the current
        push's prefix up to ``end`` — a SPEECH_ENDED whose silence window
        closed within this push would otherwise drop the final words
        (``latest`` is only concatenated after the event loop)."""
        tail_n = int(np.clip((end - chunk_t0) * self._sr, 0, len(latest)))
        if self._segment_audio is not None and len(self._segment_audio):
            return np.concatenate([self._segment_audio, latest[:tail_n]])
        s0 = max(0, int((start - chunk_t0) * self._sr))
        return latest[s0:tail_n]

    def _emit(self, audio: np.ndarray, start: float, end: float, final: bool) -> PartialTranscription:
        if len(audio) < 160:  # <10 ms — nothing to transcribe
            return PartialTranscription("", final, start, end)
        res = self.asr.transcribe(
            audio, sample_rate=self._sr, language=self.cfg.language,
            max_tokens=self.cfg.max_tokens,
        )
        return PartialTranscription(res.text, final, start, end)
