"""Sortformer streaming end-to-end diarizer — port of
``qwen3_asr_swift_tpu/models/diarization/sortformer.py``.

  NeMo log-mel (numpy, ``models/parakeet/mel.py::nemo_log_mel_reference``)
  → FastConformer encoder (Parakeet's ``encode``) → frame embeddings (what
    the speaker cache and FIFO hold)
  → encoder_proj over [spkcache ‖ fifo ‖ chunk]
  → post-LN Transformer (no positional encoding)
  → ReLU → hidden → ReLU → speakers → sigmoid.

One chunk (:func:`sortformer_chunk`) runs on the device; the ragged cache
and FIFO lengths are masks over fixed-capacity buffers. The NeMo
FIFO→speaker-cache streaming update (``_update_state``, ``_push_spkcache``)
stays numpy on the host, copied: the host reads one chunk's predictions
and embeddings back a chunk.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ...core.params import _linear, _norm, params_from_jax
from ...core.types import DiarizedSegment
from ...device import resolve_device
from ...ops.attention import NEG_INF
from ...ops.nn import layer_norm, linear
from ..parakeet.config import ParakeetConfig
from ..parakeet.encoder import encode as fastconformer_encode
from ..parakeet.encoder import init_encoder_params, subsampled_length


@dataclasses.dataclass(frozen=True)
class SortformerConfig:
    n_mels: int = 128
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    # FastConformer encoder (NeMo sortformer recipe)
    encoder_layers: int = 18
    encoder_hidden: int = 512
    num_heads: int = 8
    ffn_expansion: int = 4
    conv_kernel: int = 9
    subsampling_channels: int = 256
    subsampling: int = 8
    # transformer head
    tf_layers: int = 18
    tf_hidden: int = 192
    tf_ff: int = 768
    tf_heads: int = 8
    max_speakers: int = 4
    # streaming chunking in seconds (reference SortformerConfig.swift:65-70)
    chunk_len_s: float = 6.0
    left_context_s: float = 1.0
    right_context_s: float = 7.0
    spkcache_len: int = 188
    fifo_len: int = 40
    # post
    onset: float = 0.5
    offset: float = 0.35
    min_speech_s: float = 0.2
    min_silence_s: float = 0.2

    @property
    def core_mel(self) -> int:
        return int(self.chunk_len_s * self.sample_rate / self.hop_length)

    @property
    def left_mel(self) -> int:
        return int(self.left_context_s * self.sample_rate / self.hop_length)

    @property
    def right_mel(self) -> int:
        return int(self.right_context_s * self.sample_rate / self.hop_length)

    @property
    def chunk_mel(self) -> int:
        return self.core_mel + self.left_mel + self.right_mel

    @property
    def d_model(self) -> int:
        """Cache/FIFO embedding width = FastConformer output width."""
        return self.encoder_hidden

    def encoder_config(self) -> ParakeetConfig:
        return ParakeetConfig(
            num_mel_bins=self.n_mels, sample_rate=self.sample_rate,
            n_fft=self.n_fft, hop_length=self.hop_length, win_length=self.win_length,
            encoder_hidden=self.encoder_hidden, encoder_layers=self.encoder_layers,
            num_heads=self.num_heads, ffn_expansion=self.ffn_expansion,
            conv_kernel=self.conv_kernel, subsampling_channels=self.subsampling_channels)


CONFIG_SORTFORMER = SortformerConfig()


def config_tiny() -> SortformerConfig:
    return SortformerConfig(
        n_mels=32, encoder_layers=1, encoder_hidden=16, num_heads=2,
        ffn_expansion=2, conv_kernel=5, subsampling_channels=8,
        tf_layers=1, tf_hidden=16, tf_ff=32, tf_heads=2, max_speakers=3,
        chunk_len_s=0.16, left_context_s=0.08, right_context_s=0.08,
        spkcache_len=12, fifo_len=4)


def init_sortformer_params(rng, cfg: SortformerConfig) -> dict:
    """The reference's tree (see ``parakeet.encoder.init_encoder_params``)."""
    d = cfg.tf_hidden

    def tf_block():
        return {"ln1": _norm(d, True),
                "q": _linear(rng, d, d), "k": _linear(rng, d, d),
                "v": _linear(rng, d, d), "o": _linear(rng, d, d),
                "ln2": _norm(d, True),
                "ff1": _linear(rng, d, cfg.tf_ff),
                "ff2": _linear(rng, cfg.tf_ff, d)}

    return {
        "encoder": init_encoder_params(rng, cfg.encoder_config()),
        "encoder_proj": _linear(rng, cfg.encoder_hidden, d),
        "transformer": [tf_block() for _ in range(cfg.tf_layers)],
        "head": {"hidden": _linear(rng, d, d),
                 "spks": _linear(rng, d, cfg.max_speakers)},
    }


def _tf_block(p, x, mask, num_heads):
    """NeMo post-LN Transformer block: attn → +res → LN1 → ReLU-FFN → +res
    → LN2 (nemo TransformerEncoderBlock, pre_ln=False)."""
    b, t, d = x.shape
    hd = d // num_heads
    q = linear(x, p["q"]).reshape(b, t, num_heads, hd).transpose(1, 2)
    k = linear(x, p["k"]).reshape(b, t, num_heads, hd).transpose(1, 2)
    v = linear(x, p["v"]).reshape(b, t, num_heads, hd).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    o = torch.matmul(probs, v.float())
    attn = linear(o.transpose(1, 2).reshape(b, t, d).to(x.dtype), p["o"])
    x = layer_norm(x + attn, p["ln1"]["weight"], p["ln1"]["bias"])
    ff = linear(torch.relu(linear(x, p["ff1"])), p["ff2"])
    return layer_norm(x + ff, p["ln2"]["weight"], p["ln2"]["bias"])


def sortformer_chunk(params, cfg: SortformerConfig, chunk_mel, chunk_len: int,
                     spkcache, spk_len: int, fifo, fifo_len: int):
    """One streaming chunk.

    chunk_mel [chunk_mel_frames, mels] (normalized NeMo log-mel);
    chunk_len (valid mel frames); spkcache [spkcache_len, D]; fifo
    [fifo_len, D]; their valid lengths as ints. Returns (preds [total,
    max_speakers] fp32 sigmoid, embs [emb_cap, D], n_emb) where
    total = spkcache_len + fifo_len + emb_cap."""
    dev = chunk_mel.device
    embs, _ = fastconformer_encode(
        params["encoder"], chunk_mel[None],
        torch.tensor([chunk_len], dtype=torch.int32, device=dev), cfg.encoder_config())
    emb_cap = embs.shape[1]
    n_emb = min(subsampled_length(chunk_len), emb_cap)

    seq = torch.cat([spkcache[None].to(embs.dtype), fifo[None].to(embs.dtype), embs], dim=1)
    x = linear(seq, params["encoder_proj"])
    valid = torch.cat([torch.arange(cfg.spkcache_len, device=dev) < spk_len,
                       torch.arange(cfg.fifo_len, device=dev) < fifo_len,
                       torch.arange(emb_cap, device=dev) < n_emb])
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, None, None, :]
    for p in params["transformer"]:
        x = _tf_block(p, x, mask, cfg.tf_heads)

    # forward_speaker_sigmoids: ReLU → hidden → ReLU → spks → sigmoid
    h = torch.relu(linear(torch.relu(x), params["head"]["hidden"]))
    preds = torch.sigmoid(linear(h, params["head"]["spks"]).float())[0]
    return preds, embs[0], n_emb


class SortformerDiarizer:
    """Streaming end-to-end diarization (no separate embedding model) on one
    device (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: SortformerConfig, params, dtype: torch.dtype = torch.float32, *,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        self._loaded = True
        self.reset_state()

    @classmethod
    def init_random(cls, cfg: Optional[SortformerConfig] = None, seed: int = 0, *,
                    device="cuda", **kw):
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``
        (the reference's ``config_tiny()`` by default)."""
        cfg = cfg or config_tiny()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_sortformer_params(gen, cfg), device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "nvidia/diar_streaming_sortformer_4spk-v2",
                        cache_dir=None, offline_mode: bool = False, **kw):
        """A checkpoint from a directory, a cached snapshot or a fetch (``core/hub.py``)."""
        from ...core.hub import download_weights
        from .sortformer_convert import convert_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        cfg, params = convert_checkpoint(model_dir)
        return cls(cfg, params, **kw)

    def reset_state(self):
        cfg = self.cfg
        self._spkcache = np.zeros((cfg.spkcache_len, cfg.d_model), np.float32)
        self._spk_len = 0
        self._fifo = np.zeros((cfg.fifo_len, cfg.d_model), np.float32)
        self._fifo_len = 0

    # -- NeMo streaming_update (reference: SortformerDiarizer.swift:284-360)

    def _update_state(self, embs: np.ndarray):
        """Append a chunk's embeddings to the FIFO; overflow (oldest
        first) moves into the speaker cache, which itself drops its
        oldest rows past capacity. Handles chunks LARGER than the FIFO
        (the pretrained config's 75-frame chunks vs fifo_len 40 — the
        old in-place shuffle read stale rows and over-wrote capacity
        there)."""
        n = len(embs)
        if n == 0:
            return
        cap_f = self.cfg.fifo_len
        stream = np.concatenate([self._fifo[: self._fifo_len], embs])  # oldest..newest
        if len(stream) > cap_f:
            split = len(stream) - cap_f
            self._push_spkcache(stream[:split])
            stream = stream[split:]
        self._fifo[: len(stream)] = stream
        self._fifo_len = len(stream)

    def _push_spkcache(self, moved: np.ndarray):
        cap_c = self.cfg.spkcache_len
        if len(moved) >= cap_c:
            self._spkcache[:] = moved[-cap_c:]
            self._spk_len = cap_c
            return
        total = self._spk_len + len(moved)
        if total <= cap_c:
            self._spkcache[self._spk_len : total] = moved
            self._spk_len = total
            return
        drop = total - cap_c
        keep = self._spk_len - drop
        self._spkcache[:keep] = self._spkcache[drop : self._spk_len]
        self._spkcache[keep : keep + len(moved)] = moved
        self._spk_len = cap_c

    # -- public API -----------------------------------------------------------

    @torch.inference_mode()
    def run_chunk(self, chunk: np.ndarray, chunk_len: int):
        """:func:`sortformer_chunk` on the device over the host's cache and
        FIFO: (preds, embs, n_emb) as numpy (the chunk's one read back)."""
        dev, dt = self.device, self.dtype
        preds, embs, n_emb = sortformer_chunk(
            self.params, self.cfg, torch.from_numpy(chunk).to(dev, dt), chunk_len,
            torch.from_numpy(self._spkcache).to(dev, dt), self._spk_len,
            torch.from_numpy(self._fifo).to(dev, dt), self._fifo_len)
        return preds.cpu().numpy(), embs.float().cpu().numpy(), n_emb

    def diarize(self, audio: np.ndarray, sample_rate: int = 16000,
                progress_handler=None) -> List[DiarizedSegment]:
        from ...audio.resample import resample
        from ..parakeet.mel import nemo_log_mel_reference

        cfg = self.cfg
        if sample_rate != cfg.sample_rate:
            audio = resample(np.asarray(audio, np.float32), sample_rate, cfg.sample_rate)
        audio = np.asarray(audio, np.float32)
        if len(audio) == 0:
            return []
        self.reset_state()

        mel = np.asarray(nemo_log_mel_reference(audio, cfg.encoder_config()))  # [T, mels]
        n_frames = mel.shape[0]

        sub = cfg.subsampling
        core_mel = cfg.core_mel
        all_probs: List[np.ndarray] = []
        stt = 0
        chunk_i = 0
        total_chunks = max(1, (n_frames + core_mel - 1) // core_mel)
        while stt < n_frames:
            chunk_i += 1
            if progress_handler:
                progress_handler(chunk_i / total_chunks, f"Diarizing {chunk_i}/{total_chunks}")
            left = min(cfg.left_mel, stt)
            end = min(stt + core_mel, n_frames)
            right = min(cfg.right_mel, n_frames - end)
            piece = mel[stt - left: end + right]
            chunk = np.zeros((cfg.chunk_mel, cfg.n_mels), np.float32)
            chunk[: min(len(piece), cfg.chunk_mel)] = piece[: cfg.chunk_mel]

            preds, embs, n_emb = self.run_chunk(chunk, min(len(piece), cfg.chunk_mel))

            lc = subsampled_length(left) if left else 0
            rc = n_emb - subsampled_length(left + (end - stt)) if right else 0
            core_len = max(0, n_emb - lc - rc)
            off = cfg.spkcache_len + cfg.fifo_len + lc
            all_probs.append(preds[off: off + core_len])
            self._update_state(embs[lc: lc + core_len])
            stt = end

        probs = np.concatenate(all_probs) if all_probs else np.zeros((0, cfg.max_speakers))
        frame_s = sub * cfg.hop_length / cfg.sample_rate
        return self._binarize(probs, frame_s)

    def _binarize(self, probs: np.ndarray, frame_s: float) -> List[DiarizedSegment]:
        from ..pyannote.model import binarize

        out: List[DiarizedSegment] = []
        for spk in range(probs.shape[1] if probs.size else 0):
            for s, e in binarize(probs[:, spk], frame_s, self.cfg.onset, self.cfg.offset,
                                 self.cfg.min_speech_s, self.cfg.min_silence_s):
                out.append(DiarizedSegment(start=s, end=e, speaker=spk))
        out.sort(key=lambda d: (d.start, d.speaker))
        return out

    def unload(self):
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self):
        return self._loaded
