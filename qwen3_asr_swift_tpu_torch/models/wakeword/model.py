"""Wake-word / keyword spotting: streaming Zipformer transducer — port of
``qwen3_asr_swift_tpu/models/wakeword/model.py``.

The encoder (zipformer.py) runs on one device, the card unless the caller
asks for the CPU; the stateless-decoder/joiner beam search
(kws_decoder.py, a copy) runs on the host over the returned joiner-space
frames. Batch detection (:meth:`WakeWordDetector.detect_keywords`) takes
the fbank of the whole clip at once, sets rows past the real frames to
kaldi silence (``_PAD_MEL``), gathers the windows by index and runs
:func:`encode_windows`, a loop of :func:`encode_chunk` over the windows;
a streaming session (:class:`WakeWordSession`) runs one window at a time
as audio arrives. Both give the same frames.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import WakeWordModel
from ...device import resolve_device
from ...ops.fbank import kaldi_fbank
from .context_graph import ContextGraph, Keyword
from .kws_decoder import KeywordDetection, StreamingKwsDecoder
from .zipformer import (ZipformerConfig, decoder_out, encode_chunk,
                        encode_windows, init_states, init_zipformer_params,
                        joiner_logits, param_count)

_PAD_MEL = -15.0  # ~kaldi log-energy of silence (StreamingSession.swift:110)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().float().cpu().numpy()


def detect_frames(params, cfg: ZipformerConfig, audio: torch.Tensor, n_valid_frames: int,
                  n_windows: int) -> torch.Tensor:
    """The batch path's device half (the reference's ``_detect_program``):
    fbank of the padded clip ``audio`` [S] (raw [-1, 1]), rows at or after
    ``n_valid_frames`` set to kaldi silence, ``n_windows`` windows of
    ``mel_window`` rows every ``mel_stride`` gathered by index, then
    :func:`encode_windows` from zeroed states → [n_windows * chunk//2,
    joiner_dim]."""
    fb = kaldi_fbank(audio * 32768.0)                           # [F, 80]
    valid = (torch.arange(fb.shape[0], device=fb.device) < n_valid_frames)[:, None]
    fb = torch.where(valid, fb, torch.full((), _PAD_MEL, dtype=fb.dtype, device=fb.device))
    idx = (torch.arange(n_windows, device=fb.device) * cfg.mel_stride)[:, None] \
        + torch.arange(cfg.mel_window, device=fb.device)[None]
    wins = fb[idx].to(params["encoder_proj"]["kernel"].dtype)
    out, _ = encode_windows(params, cfg, wins[:, None],
                            init_states(cfg, 1, wins.dtype, wins.device))
    return out[0]


class WakeWordDetector(WakeWordModel):
    """Batch + streaming keyword detection (SpeechWakeWord.swift:14-89) on
    one device (the card unless the caller asks for the CPU)."""

    def __init__(self, params: dict, keywords: Sequence[Keyword],
                 config: Optional[ZipformerConfig] = None,
                 context_score: float = 0.5, ac_threshold: float = 0.15,
                 num_trailing_blanks: int = 1, auto_reset_seconds: float = 1.5,
                 dtype: torch.dtype = torch.float32, *, device="cuda"):
        self.config = config or ZipformerConfig()
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        self.graph = ContextGraph(keywords, context_score=context_score,
                                  ac_threshold=ac_threshold)
        self.keywords = list(keywords)
        self.num_trailing_blanks = num_trailing_blanks
        self.auto_reset_seconds = auto_reset_seconds
        self._loaded = True

    # -- loading ----------------------------------------------------------

    @classmethod
    def init_random(cls, keywords: Sequence[Keyword], seed: int = 0,
                    config: Optional[ZipformerConfig] = None, *, device="cuda",
                    **kw) -> "WakeWordDetector":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``."""
        cfg = config or ZipformerConfig()
        dev = resolve_device(device)
        params = init_zipformer_params(torch.Generator(device=dev).manual_seed(seed), cfg)
        return cls(params, keywords, config=cfg, device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "kws-zipformer",
                        keywords: Sequence[Keyword] = (),
                        cache_dir=None, offline_mode: bool = False,
                        progress_handler=None, **kw) -> "WakeWordDetector":
        """Load a converted checkpoint directory: ``model.safetensors`` in
        the canonical tree (see convert.py for the icefall mapping) plus
        ``config.json`` hyperparameters, from a directory, a cached snapshot or a fetch (``core/hub.py``)."""
        import dataclasses
        from pathlib import Path

        from ...core.hub import download_weights
        from ...core.weights import load_safetensors, relist, unflatten

        model_dir = Path(download_weights(model_id, cache_dir=cache_dir,
                                          offline_mode=offline_mode,
                                          progress_handler=progress_handler))
        cfg = ZipformerConfig()
        cfg_path = model_dir / "config.json"
        if cfg_path.exists():
            raw = json.loads(cfg_path.read_text())
            fields = {f.name for f in dataclasses.fields(ZipformerConfig)}
            cfg = ZipformerConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                     for k, v in raw.items() if k in fields})
        flat = load_safetensors(model_dir)
        if any(k.startswith("encoder_embed.") or k.startswith("encoder.encoders.")
               for k in flat):
            from .convert import convert_icefall_tree
            params = convert_icefall_tree(flat, cfg)
        else:
            params = relist(unflatten(flat))
        return cls(params, keywords, config=cfg, **kw)

    # -- inference --------------------------------------------------------

    def detect(self, audio: np.ndarray, sample_rate: int = 16000
               ) -> Sequence[Tuple[str, float, float]]:
        """Batch detection: (keyword, time_s, mean_token_prob) tuples
        (protocol surface); the richer KeywordDetection list is available
        via ``detect_keywords``."""
        hits = self.detect_keywords(audio, sample_rate)
        return [(h.phrase, h.time(), h.score) for h in hits]

    def detect_keywords(self, audio: np.ndarray, sample_rate: int = 16000
                        ) -> List[KeywordDetection]:
        """Batch detection: the encoder over every chunk window of the clip
        (:meth:`_batch_encoder_frames`), then the host beam search over the
        whole 25 Hz frame sequence."""
        if sample_rate != 16000:
            audio = _resample(audio, sample_rate)
        frames = self._batch_encoder_frames(np.asarray(audio, np.float32))
        if frames is None:
            return []
        return self.make_kws_decoder().step_chunk(frames)

    @torch.inference_mode()
    def _batch_encoder_frames(self, audio: np.ndarray):
        """Joiner-space frames for a whole utterance by :func:`detect_frames`;
        None if the audio is shorter than one fbank frame. Windows and tail
        as ``WakeWordSession``'s: windows of ``mel_window`` frames advancing
        ``mel_stride``, the tail (≥ 1 frame) padded with kaldi-silence rows.
        The reference pads the window count to a power of two for a static
        scan length and drops the padded windows' frames (they come after
        every real window); the port runs the real windows only."""
        cfg = self.config
        if len(audio) < WakeWordSession.FRAME:
            return None
        hop, flen = WakeWordSession.HOP, WakeWordSession.FRAME
        f_real = 1 + (len(audio) - flen) // hop
        n_full = max(0, (f_real - cfg.mel_window) // cfg.mel_stride + 1)
        n_real = n_full + (1 if n_full * cfg.mel_stride < f_real else 0)
        f_need = (n_real - 1) * cfg.mel_stride + cfg.mel_window
        need_samples = (f_need - 1) * hop + flen
        padded = np.zeros(need_samples, np.float32)
        padded[: min(len(audio), need_samples)] = audio[:need_samples]
        out = detect_frames(self.params, cfg, torch.from_numpy(padded).to(self.device),
                            min(f_real, f_need), n_real)
        return out.float().cpu().numpy()

    def new_session(self) -> "WakeWordSession":
        return WakeWordSession(self)

    def make_kws_decoder(self, beam: int = 4) -> StreamingKwsDecoder:
        """Beam-search decoder wired to this model's transducer head
        (SpeechWakeWord.swift:95-147), over the head's leaves as fp32 numpy."""
        cfg = self.config
        head = {k: _numpy_tree(self.params[k]) for k in ("decoder", "joiner")}
        return StreamingKwsDecoder(
            decoder_fn=lambda ctx: decoder_out(head, ctx, cfg),
            joiner_fn=lambda enc, dec: joiner_logits(head, enc, dec),
            context_graph=self.graph, blank_id=cfg.blank_id,
            context_size=cfg.context_size, beam=beam,
            num_trailing_blanks=self.num_trailing_blanks,
            auto_reset_seconds=self.auto_reset_seconds)

    def num_params(self) -> int:
        return param_count(self.params)

    def warm_up(self) -> None:
        self.detect(np.zeros(16000, np.float32))

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded


class WakeWordSession:
    """Streaming detection over pushed audio (StreamingSession.swift:9-144).

    Raw samples accrue in a buffer; whenever a full encoder window's worth
    is available — 45 kaldi-fbank frames = 7440 samples at the 25 ms/10 ms
    framing — one encoder chunk consumes it (advancing 5120 samples = 32
    frames of stride) and emits 8 joiner-space frames at 25 Hz into the
    beam search. Encoder caches and the beam persist across pushes:
    keywords spanning chunk boundaries fire. One device read a window (its
    frames, for the host's beam search)."""

    HOP = 160
    FRAME = 400

    def __init__(self, model: WakeWordDetector, collect_encoder: bool = False):
        self.model = model
        cfg = model.config
        self.window_samples = (cfg.mel_window - 1) * self.HOP + self.FRAME
        self.stride_samples = cfg.mel_stride * self.HOP
        self._buf = np.zeros(0, np.float32)
        self._states = init_states(cfg, 1, model.dtype, model.device)
        self._decoder = model.make_kws_decoder()
        # parity hook: retain joiner-space encoder frames (tests only)
        self.collect_encoder = collect_encoder
        self.encoder_frames: List[np.ndarray] = []

    def push(self, samples: np.ndarray) -> List[KeywordDetection]:
        self._buf = np.concatenate([self._buf, np.asarray(samples, np.float32)])
        return self._drain()

    def finalize(self) -> List[KeywordDetection]:
        """Encode the remaining tail: compute its mel frames and pad up to
        a full window with kaldi-silence frames
        (StreamingSession.swift:101-117)."""
        cfg = self.model.config
        hits: List[KeywordDetection] = self._drain()
        if len(self._buf) >= self.FRAME:
            fb = self._fbank(self._buf)
            pad = torch.full((cfg.mel_window - fb.shape[0], cfg.num_mel_bins), _PAD_MEL,
                             dtype=fb.dtype, device=fb.device)
            window = torch.cat([fb, pad]) if pad.shape[0] > 0 else fb[: cfg.mel_window]
            hits.extend(self._encode_window(window[None]))
            self._buf = np.zeros(0, np.float32)
        return hits

    def _fbank(self, samples: np.ndarray) -> torch.Tensor:
        return kaldi_fbank(torch.from_numpy(samples * 32768.0).to(self.model.device))

    def _drain(self) -> List[KeywordDetection]:
        hits: List[KeywordDetection] = []
        while len(self._buf) >= self.window_samples:
            window = self._fbank(self._buf[: self.window_samples])[None]
            hits.extend(self._encode_window(window))
            self._buf = self._buf[self.stride_samples:]
        return hits

    @torch.inference_mode()
    def _encode_window(self, window) -> List[KeywordDetection]:
        out, self._states = encode_chunk(self.model.params, self.model.config,
                                         window.to(self.model.dtype), self._states)
        frames = out[0].float().cpu().numpy()
        if self.collect_encoder:
            self.encoder_frames.append(frames)
        return self._decoder.step_chunk(frames)

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)
        self._states = init_states(self.model.config, 1, self.model.dtype, self.model.device)
        self._decoder.reset()


def _resample(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    from ...audio.resample import resample

    return resample(np.asarray(audio, np.float32), sample_rate, 16000)
