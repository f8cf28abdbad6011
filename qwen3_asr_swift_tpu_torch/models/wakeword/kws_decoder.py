"""Modified beam search over a stateless transducer for keyword spotting.

TPU-native analog of the reference's streaming KWS decoder
(reference: Sources/SpeechWakeWord/StreamingKwsDecoder.swift:27-272, a port
of icefall's kws beam search): a small per-frame beam (default 4) expands
hypotheses over joiner logits, the Aho-Corasick :class:`ContextGraph`
boosts registered keyword paths, and a detection fires when the
length-normalized top hypothesis sits on a matched terminal whose trailing
window of per-token acoustic probabilities clears that keyword's
threshold, with ``num_trailing_blanks`` debounce and auto-reset after
silence. The backend is abstract — ``decoder_fn(context_tokens)`` and
``joiner_fn(enc_frame, dec_out)`` close over the Zipformer transducer head
(or a stub in unit tests, exactly the reference's closure-backend design).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .context_graph import ContextGraph, ContextState

DecoderFn = Callable[[Sequence[int]], np.ndarray]
JoinerFn = Callable[[np.ndarray, np.ndarray], np.ndarray]


@dataclasses.dataclass
class KeywordDetection:
    """A single keyword emission (StreamingKwsDecoder.swift:4-19)."""

    phrase: str
    token_ids: List[int]
    timestamps: List[int]
    frame_index: int
    #: mean per-token acoustic probability over the matched window — the
    #: confidence the beam search actually thresholded on
    score: float = 1.0

    def time(self, frame_shift_seconds: float = 0.04) -> float:
        return self.frame_index * frame_shift_seconds


@dataclasses.dataclass
class _Hypothesis:
    ys: List[int]
    log_prob: float
    ac_probs: List[float]
    timestamps: List[int]
    context_state: ContextState
    num_trailing_blanks: int

    @property
    def key(self) -> str:
        return "_".join(map(str, self.ys))


class StreamingKwsDecoder:
    """Single-stream modified beam search with context-graph boosting."""

    def __init__(self, decoder_fn: DecoderFn, joiner_fn: JoinerFn,
                 context_graph: ContextGraph, blank_id: int = 0,
                 unk_id: Optional[int] = None, context_size: int = 2,
                 beam: int = 4, num_trailing_blanks: int = 1,
                 blank_penalty: float = 0.0,
                 frame_shift_seconds: float = 0.04,
                 auto_reset_seconds: float = 1.5):
        self.decoder_fn = decoder_fn
        self.joiner_fn = joiner_fn
        self.context_graph = context_graph
        self.blank_id = blank_id
        self.unk_id = unk_id if unk_id is not None else blank_id
        self.context_size = context_size
        self.beam = beam
        self.num_trailing_blanks = num_trailing_blanks
        self.blank_penalty = blank_penalty
        self.frame_shift_seconds = frame_shift_seconds
        self.auto_reset_frames = max(1, round(auto_reset_seconds / frame_shift_seconds))
        self._dec_cache: Dict[Tuple[int, ...], np.ndarray] = {}
        self.reset()

    def reset(self) -> None:
        """Full stream reset: beam state AND the stream clock (new audio)."""
        self._t = 0
        self._reset_beam()

    def _reset_beam(self) -> None:
        """Reset the search state but keep the stream clock — detections
        after a reset must still report stream-absolute frame indices."""
        self._frames_since_emission = 0
        self._dec_cache.clear()
        init_ys = [-1] * max(self.context_size - 1, 0) + [self.blank_id]
        self.beam_list: List[_Hypothesis] = [_Hypothesis(
            ys=init_ys, log_prob=0.0, ac_probs=[], timestamps=[],
            context_state=self.context_graph.root, num_trailing_blanks=0)]

    def _decoder_for(self, ys: Sequence[int]) -> np.ndarray:
        ctx = tuple(ys[-self.context_size:])
        cached = self._dec_cache.get(ctx)
        if cached is None:
            cached = np.asarray(self.decoder_fn(list(ctx)))
            self._dec_cache[ctx] = cached
        return cached

    def step(self, encoder_frame: np.ndarray) -> List[KeywordDetection]:
        """Advance one encoder output frame (already in joiner space).

        Candidate scoring is vectorized: per-hypothesis softmaxes stack
        into one [H, V] score matrix and a partial top-``beam`` selection
        replaces the per-token Python loop (H·V tuple churn per frame was
        the dominant host cost of batch detection)."""
        emissions: List[KeywordDetection] = []

        rows = []
        for hyp in self.beam_list:
            dec_out = self._decoder_for(hyp.ys)
            logits = np.asarray(self.joiner_fn(encoder_frame, dec_out), np.float64)
            if self.blank_penalty and self.blank_id < logits.shape[0]:
                logits[self.blank_id] -= self.blank_penalty
            rows.append(logits)
        logits_all = np.stack(rows)                              # [H, V]
        m = logits_all.max(axis=1, keepdims=True)
        exps = np.exp(logits_all - m)
        probs_all = exps / exps.sum(axis=1, keepdims=True)
        log_probs_all = np.log(np.maximum(probs_all, 1e-300))
        base = np.asarray([h.log_prob for h in self.beam_list])
        scores = (base[:, None] + log_probs_all).ravel()
        v = logits_all.shape[1]
        k = min(self.beam, scores.size)
        order = np.argpartition(scores, -k)[-k:]
        order = order[np.argsort(scores[order])[::-1]]

        next_beam: Dict[str, _Hypothesis] = {}
        for idx in order:
            i, token = divmod(int(idx), v)
            token_prob = float(probs_all[i, token])
            src = self.beam_list[i]
            hyp = _Hypothesis(
                ys=list(src.ys), log_prob=0.0, ac_probs=list(src.ac_probs),
                timestamps=list(src.timestamps), context_state=src.context_state,
                num_trailing_blanks=src.num_trailing_blanks + 1)

            context_score = 0.0
            if token != self.blank_id and token != self.unk_id:
                hyp.ys.append(token)
                hyp.timestamps.append(self._t)
                hyp.ac_probs.append(token_prob)
                boost, nxt, _ = self.context_graph.forward_one_step(
                    hyp.context_state, token)
                context_score = boost
                hyp.context_state = nxt
                hyp.num_trailing_blanks = 0
                if nxt.token == -1:
                    # dropped back to root: rewind the BPE prefix
                    tail = min(self.context_size, len(hyp.ys))
                    del hyp.ys[len(hyp.ys) - tail:]
                    hyp.ys.extend([-1] * max(self.context_size - 1, 0) + [self.blank_id])
            hyp.log_prob = float(scores[idx]) + context_score

            key = hyp.key
            existing = next_beam.get(key)
            if existing is not None:
                existing.log_prob = _log_add_exp(existing.log_prob, hyp.log_prob)
            else:
                next_beam[key] = hyp
        self.beam_list = list(next_beam.values())

        top = max(self.beam_list,
                  key=lambda h: h.log_prob / max(len(h.ys), 1), default=None)
        if top is not None:
            matched_flag, matched = self.context_graph.is_matched(top.context_state)
            if matched_flag and matched is not None and matched.level > 0 \
                    and len(top.ac_probs) >= matched.level:
                window = top.ac_probs[-matched.level:]
                ac_prob = sum(window) / matched.level
                if top.num_trailing_blanks > self.num_trailing_blanks \
                        and ac_prob >= matched.ac_threshold:
                    emissions.append(KeywordDetection(
                        phrase=matched.phrase,
                        token_ids=top.ys[-matched.level:],
                        timestamps=top.timestamps[-matched.level:],
                        frame_index=self._t,
                        score=float(ac_prob)))
                    self._reset_beam()
                    self._t += 1
                    return emissions

        self._t += 1
        # auto-reset counts SILENCE (consecutive trailing blanks on the
        # best hypothesis), not wall clock — an unconditional 1.5 s reset
        # would wipe a partially matched phrase mid-keyword
        if top is not None and top.num_trailing_blanks == 0:
            self._frames_since_emission = 0
        else:
            self._frames_since_emission += 1
        if self._frames_since_emission >= self.auto_reset_frames:
            self._reset_beam()
        return emissions

    def step_chunk(self, frames: np.ndarray) -> List[KeywordDetection]:
        out: List[KeywordDetection] = []
        for frame in np.asarray(frames):
            out.extend(self.step(frame))
        return out


def _log_add_exp(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(-abs(a - b)))
