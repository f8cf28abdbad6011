"""Streaming RNNT ASR: cache-aware conformer + LSTM prediction net +
greedy decode on the device + <EOU> turn detection — port of
``qwen3_asr_swift_tpu/models/parakeet_streaming/model.py``.

A chunk — streaming mel → subsample → conformer → per-frame RNNT greedy
with the max-symbols-per-frame cap — runs on the device; the session
reads the chunk's emitted ids, their log-probs, the count and the EOU flag
back in one copy (its only sync a chunk). The reference's RNNT loop is a
``lax.while_loop``; here it is a fixed count of ``out_frames ×
max_symbols_per_frame`` steps (the most the loop can take: each step
emits or advances a frame, and a frame takes at most that many), every
write masked by ``(t < T) & (n < max_out)``, so the steps past the
reference's end are exact no-ops. The EOU debounce, the forced end of an
utterance and the flushed tail are host logic, as written there.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...core.params import _linear, _normal, params_from_jax
from ...core.protocols import SpeechRecognitionModel
from ...core.types import PartialTranscription, TranscriptionResult
from ...device import resolve_device
from ...ops.nn import linear
from ..parakeet.model import lstm_step
from .config import CONFIG_EOU_120M, CONFIG_NEMOTRON_06B, StreamingConformerConfig, config_tiny
from .encoder import (
    EncoderCaches,
    encode_chunk,
    init_caches,
    init_encoder_params,
    streaming_log_mel,
)


@dataclasses.dataclass(frozen=True)
class StreamingResult:
    """Per-chunk decode outcome surfaced to the session."""

    text: str
    is_final: bool
    confidence: float
    eou_detected: bool
    segment_index: int


def init_decoder_params(rng, cfg: StreamingConformerConfig) -> dict:
    """The reference's prediction net and joint tree."""
    dh = cfg.decoder_hidden
    layers = [{"wx": _normal(rng, (dh, 4 * dh), 0.02), "wh": _normal(rng, (dh, 4 * dh), 0.02),
               "bias": np.zeros((4 * dh,), np.float32)} for _ in range(cfg.decoder_layers)]
    return {
        "embed": _normal(rng, (cfg.vocab_size + 1, cfg.decoder_hidden), 0.02),
        "lstm": layers,
        "joint_enc": _linear(rng, cfg.encoder_hidden, cfg.joint_hidden),
        "joint_pred": _linear(rng, cfg.decoder_hidden, cfg.joint_hidden),
        "joint_out": _linear(rng, cfg.joint_hidden, cfg.vocab_size + 1),
    }


def rnnt_chunk_decode(dec_params, cfg: StreamingConformerConfig, encoded,
                      h, c, last_token):
    """Greedy RNNT over one chunk's encoder frames, on the device.

    encoded: [T, D] (batch 1). Carry: LSTM (h, c) [L, 1, dh] and the last
    non-blank token (a 0-d int tensor). Returns (tokens [T*max_sym],
    logprobs, n_emitted, eou_seen, h, c, last_token), the scalars as 0-d
    tensors. Blank advances the frame; a non-blank token re-runs the joint
    on the same frame up to max_symbols_per_frame (the cap emits the
    capping token, then advances)."""
    t_frames = encoded.shape[0]
    max_out = t_frames * cfg.max_symbols_per_frame
    blank = cfg.vocab_size  # last joint logit
    dev = encoded.device

    def pred_out(token, h, c):
        emb = dec_params["embed"][token.long()[None]]           # [1, dh]
        return lstm_step(dec_params["lstm"], emb, h, c)

    def joint(enc_t, dec_o):
        hid = torch.relu(linear(enc_t[None], dec_params["joint_enc"])
                         + linear(dec_o, dec_params["joint_pred"]))
        return linear(hid, dec_params["joint_out"])[0].float()

    dec_o, h, c = pred_out(last_token, h, c)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    t, sym, n = zero, zero, zero
    tokens = torch.zeros((max_out,), dtype=torch.int32, device=dev)
    logps = torch.zeros((max_out,), dtype=torch.float32, device=dev)
    eou = torch.zeros((), dtype=torch.bool, device=dev)
    last = last_token
    for _ in range(max_out):
        live = (t < t_frames) & (n < max_out)
        logits = joint(encoded[t.clamp(max=t_frames - 1)], dec_o)
        logp = torch.log_softmax(logits, dim=-1)
        tok = logits.argmax().to(torch.int32)
        is_blank = tok == blank
        is_eou = tok == cfg.eou_token_id

        emit = live & ~is_blank & ~is_eou
        capped = emit & (sym + 1 >= cfg.max_symbols_per_frame)
        slot = n.clamp(max=max_out - 1).long()
        tokens[slot] = torch.where(emit, tok, tokens[slot])
        logps[slot] = torch.where(emit, logp[tok.long()], logps[slot])
        n = n + emit.to(torch.int32)
        eou = eou | (live & is_eou)

        dec_o2, h2, c2 = pred_out(tok, h, c)
        dec_o = torch.where(emit, dec_o2, dec_o)
        h = torch.where(emit, h2, h)
        c = torch.where(emit, c2, c)
        last = torch.where(emit, tok, last)
        adv = live & (is_blank | is_eou | capped)
        t = t + adv.to(torch.int32)
        sym = torch.where(adv, zero, torch.where(live, sym + 1, sym))
    return tokens, logps, n, eou, h, c, last


class StreamingSession:
    """One streaming utterance pipeline: sample buffering, the chunk step,
    <EOU> debounce, partial/final split (reference:
    StreamingSession.swift:133-397)."""

    def __init__(self, model: "ParakeetStreamingASR", eou_debounce_ms: int = 1280):
        self.model = model
        self.cfg = model.cfg
        self.eou_debounce_ms = eou_debounce_ms
        self._buffer = np.zeros((0,), np.float32)
        dev, dt = model.device, model.dtype
        self._caches = init_caches(self.cfg, 1, dt, dev)
        dh, dl = self.cfg.decoder_hidden, self.cfg.decoder_layers
        self._h = torch.zeros((dl, 1, dh), dtype=dt, device=dev)
        self._c = torch.zeros((dl, 1, dh), dtype=dt, device=dev)
        self._last_token = torch.full((), self.cfg.vocab_size, dtype=torch.int32,
                                      device=dev)  # blank
        self._tokens: List[int] = []
        self._logprobs: List[float] = []
        self._segment = 0
        self._eou_offset = 0
        self._eou_first_at: Optional[int] = None
        self._samples_done = 0
        self._last_final = ""

    # -- push / finalize ------------------------------------------------

    def push_audio(self, samples: np.ndarray) -> List[StreamingResult]:
        self._buffer = np.concatenate([self._buffer, np.asarray(samples, np.float32)])
        spc = self.cfg.samples_per_chunk
        out = []
        while len(self._buffer) >= spc:
            chunk, self._buffer = self._buffer[:spc], self._buffer[spc:]
            res = self._process(chunk)
            if res is not None:
                out.append(res)
        return out

    def finalize(self) -> List[StreamingResult]:
        spc = self.cfg.samples_per_chunk
        out: List[StreamingResult] = []
        if len(self._buffer):
            chunk = np.zeros(spc, np.float32)
            chunk[: len(self._buffer)] = self._buffer[:spc]
            self._buffer = np.zeros((0,), np.float32)
            # the flushed tail can itself confirm an EOU and emit a final
            # segment (which advances _eou_offset past its tokens) —
            # dropping it would lose the last segment's text
            res = self._process(chunk)
            if res is not None:
                out.append(res)
        pending = self._tokens[self._eou_offset:]
        if not pending:
            return out
        text = self.model.decode_tokens(pending)
        conf = self._confidence(self._logprobs[self._eou_offset:])
        self._eou_offset = len(self._tokens)
        out.append(StreamingResult(text, True, conf, False, self._segment))
        return out

    def force_end_of_utterance(self) -> Optional[StreamingResult]:
        """External boundary (e.g. VAD silence) — emit pending text as
        final, keep all streaming state (reference: forceEndOfUtterance)."""
        pending = self._tokens[self._eou_offset:]
        logps = self._logprobs[self._eou_offset:]
        self._eou_offset = len(self._tokens)
        self._eou_first_at = None
        if not pending:
            return None
        text = self.model.decode_tokens(pending)
        if not text:
            return None
        seg = self._segment
        self._segment += 1
        self._last_final = text
        return StreamingResult(text, True, self._confidence(logps), True, seg)

    # -- internals --------------------------------------------------------

    @staticmethod
    def _confidence(logps: Sequence[float]) -> float:
        return float(min(1.0, np.exp(np.mean(logps)))) if len(logps) else 0.0

    def _process(self, chunk: np.ndarray) -> Optional[StreamingResult]:
        tokens, logps, n, eou, caches, h, c, last = self.model.chunk_step(
            chunk, self._caches, self._h, self._c, self._last_token)
        self._caches, self._h, self._c, self._last_token = caches, h, c, last
        # the chunk's one read back: ids, log-probs, count and EOU flag
        host = torch.cat([tokens.double(), logps.double(),
                          torch.stack([n, eou.to(torch.int32)]).double()]).cpu().numpy()
        m = len(tokens)
        n, eou = int(host[2 * m]), bool(host[2 * m + 1])
        new_tokens = [int(t) for t in host[:n]]
        self._tokens.extend(new_tokens)
        self._logprobs.extend(float(x) for x in host[m: m + n])

        # EOU debounce (reference: StreamingSession.swift:327-345)
        self._samples_done += len(chunk)
        eou_confirmed = False
        if bool(eou):
            if new_tokens:
                self._eou_first_at = None
            elif self._eou_first_at is None:
                self._eou_first_at = self._samples_done
            if self._eou_first_at is not None:
                elapsed_ms = (self._samples_done - self._eou_first_at) * 1000 // self.cfg.sample_rate
                if elapsed_ms >= self.eou_debounce_ms:
                    eou_confirmed = True
        else:
            self._eou_first_at = None

        pending = self._tokens[self._eou_offset:]
        text = self.model.decode_tokens(pending)
        if not text:
            if eou_confirmed:
                self._eou_offset = len(self._tokens)
                self._segment += 1
                self._eou_first_at = None
            return None
        conf = self._confidence(self._logprobs[self._eou_offset:])
        if eou_confirmed:
            self._eou_offset = len(self._tokens)
            seg = self._segment
            self._segment += 1
            self._eou_first_at = None
            if text == self._last_final:
                return None
            self._last_final = text
            return StreamingResult(text, True, conf, True, seg)
        return StreamingResult(text, False, conf, False, self._segment)


class ParakeetStreamingASR(SpeechRecognitionModel):
    """Cache-aware streaming RNNT (EOU 120M preset) on one device (the card
    unless the caller asks for the CPU)."""

    DEFAULT_CONFIG = CONFIG_EOU_120M
    DEFAULT_MODEL_ID = "nvidia/parakeet-rnnt-eou-120m"

    def __init__(self, cfg: StreamingConformerConfig, encoder_params, decoder_params,
                 vocabulary: Optional[Sequence[str]] = None,
                 dtype: torch.dtype = torch.float32, *, device="cuda"):
        self.cfg = cfg
        self.vocabulary = list(vocabulary) if vocabulary else None
        self.device = resolve_device(device)
        self.dtype = dtype
        self.encoder_params = params_from_jax(encoder_params, self.device, dtype)
        self.decoder_params = params_from_jax(decoder_params, self.device, dtype)
        self._loaded = True

    @torch.inference_mode()
    def chunk_step(self, chunk_samples: np.ndarray, caches: EncoderCaches, h, c, last_token):
        """One chunk on the device: streaming mel, :func:`encode_chunk`,
        :func:`rnnt_chunk_decode` → (tokens, logps, n, eou, caches, h, c,
        last), every one a device tensor."""
        chunk = torch.from_numpy(np.asarray(chunk_samples, np.float32)).to(self.device, self.dtype)
        mel, new_tail = streaming_log_mel(chunk[None], caches.sample_tail, self.cfg)
        encoded, caches = encode_chunk(self.encoder_params, self.cfg, mel.to(self.dtype), caches)
        caches = dataclasses.replace(caches, sample_tail=new_tail)
        tokens, logps, n, eou, h, c, last = rnnt_chunk_decode(
            self.decoder_params, self.cfg, encoded[0], h, c, last_token)
        return tokens, logps, n, eou, caches, h, c, last

    # -- constructors -----------------------------------------------------

    @classmethod
    def init_random(cls, cfg: Optional[StreamingConformerConfig] = None, seed: int = 0, *,
                    device="cuda", **kw):
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``
        (the reference's ``config_tiny()`` by default)."""
        cfg = cfg or config_tiny()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_encoder_params(gen, cfg), init_decoder_params(gen, cfg),
                   device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: Optional[str] = None, cache_dir=None,
                        offline_mode: bool = False, **kw):
        """A checkpoint from a directory, a cached snapshot or a fetch (``core/hub.py``)."""
        from ...core.hub import download_weights
        from .convert import convert_streaming_checkpoint, load_vocabulary

        model_id = model_id or cls.DEFAULT_MODEL_ID
        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode,
                                     additional_files=("vocab.txt", "tokenizer.model"))
        cfg = cls.DEFAULT_CONFIG
        enc, dec = convert_streaming_checkpoint(model_dir, cfg)
        vocab = load_vocabulary(model_dir)
        return cls(cfg, enc, dec, vocabulary=vocab, **kw)

    # -- API ----------------------------------------------------------------

    def new_session(self, eou_debounce_ms: int = 1280) -> StreamingSession:
        return StreamingSession(self, eou_debounce_ms)

    def decode_tokens(self, ids: Sequence[int]) -> str:
        if not ids:
            return ""
        if self.vocabulary:
            pieces = [self.vocabulary[i] for i in ids if 0 <= i < len(self.vocabulary)]
            return "".join(pieces).replace("▁", " ").strip()
        return " ".join(str(i) for i in ids)

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16000, **kw) -> TranscriptionResult:
        """Batch entry point: stream the whole clip through one session."""
        import time

        from ...audio.resample import resample

        t0 = time.perf_counter()
        if sample_rate != self.cfg.sample_rate:
            audio = resample(np.asarray(audio, np.float32), sample_rate, self.cfg.sample_rate)
        session = self.new_session()
        events = session.push_audio(np.asarray(audio, np.float32))
        events += session.finalize()
        finals = [r for r in events if r.is_final]
        if finals:
            text = " ".join(r.text for r in finals)
        else:
            text = events[-1].text if events else ""
        dur = len(audio) / self.cfg.sample_rate
        wall = time.perf_counter() - t0
        conf = float(np.mean([r.confidence for r in (finals or events)])) if events else 0.0
        return TranscriptionResult(text=text.strip(), confidence=conf, duration=dur,
                                   processing_time=wall)

    def transcribe_stream(self, chunks, sample_rate: int = 16000):
        """Generator: audio chunks in → PartialTranscription events out."""
        session = self.new_session()
        t = 0.0
        for chunk in chunks:
            t_start = t
            t += len(chunk) / sample_rate
            for r in session.push_audio(np.asarray(chunk, np.float32)):
                yield PartialTranscription(text=r.text, is_final=r.is_final,
                                           segment_start=t_start, segment_end=t)
        for r in session.finalize():
            yield PartialTranscription(text=r.text, is_final=True,
                                       segment_start=t, segment_end=t)

    def warm_up(self) -> None:
        s = self.new_session()
        s.push_audio(np.zeros(self.cfg.samples_per_chunk, np.float32))

    def unload(self) -> None:
        self.encoder_params = None
        self.decoder_params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded


class NemotronStreamingASR(ParakeetStreamingASR):
    """English streaming 0.6B with native punctuation/caps (reference:
    Sources/NemotronStreamingASR/NemotronStreamingASR.swift:13-137 — the
    identical cache-aware session pattern at a larger size)."""

    DEFAULT_CONFIG = CONFIG_NEMOTRON_06B
    DEFAULT_MODEL_ID = "nvidia/nemotron-streaming-asr-0.6b"
