"""Parakeet-TDT: prediction net + joint + TDT greedy decode on the device —
port of ``qwen3_asr_swift_tpu/models/parakeet/model.py``.

The reference's decode is one ``lax.while_loop``, batched over B
utterances with independent time cursors:

  while any slot unfinished:
      joint(enc[b, t_b], dec_state_b) → token/duration logits
      blank → t_b += 1
      token → emit (if ≥ first_text_token), t_b += max(duration, 1),
              LSTM step on the emitted token

Here the steps run on the device in chunks of :data:`TDT_CHECK_STEPS`,
and the host reads ``any(active)`` once a chunk (the loop's only reads,
with the tokens at its end). Every update of a step is masked by
``active``, so the steps past the end of a chunk are exact no-ops and the
tokens are the reference's.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...core.params import _linear, _normal, params_from_jax
from ...core.protocols import SpeechRecognitionModel
from ...core.types import TranscriptionResult
from ...device import resolve_device
from ...ops.nn import linear
from .config import CONFIG_06B, ParakeetConfig
from .encoder import encode, init_encoder_params
from .mel import nemo_log_mel, nemo_num_frames, prepare_nemo_audio

PARAKEET_BUCKETS_S = (8, 16, 32, 64, 128, 320, 640)

#: decode steps between two host reads of ``any(active)``
TDT_CHECK_STEPS = 32


def init_decoder_params(rng, cfg: ParakeetConfig) -> dict:
    """Prediction network (embedding + LSTM layers) and TDT joint, in the
    reference's tree; blank embeds as zeros."""
    d = cfg.decoder_hidden
    embed = _normal(rng, (cfg.vocab_size + 1, d), 0.02)
    embed[cfg.blank_token_id] = 0.0
    params = {
        "embed": embed,
        "lstm": [],
        "joint_enc": _linear(rng, cfg.encoder_hidden, cfg.joint_hidden),
        "joint_pred": _linear(rng, d, cfg.joint_hidden),
        "joint_out": _linear(rng, cfg.joint_hidden,
                                 cfg.vocab_size + 1 + cfg.num_duration_bins),
    }
    for _ in range(cfg.decoder_layers):
        params["lstm"].append({"wx": _normal(rng, (d, 4 * d), 1.0 / np.sqrt(d)),
                               "wh": _normal(rng, (d, 4 * d), 1.0 / np.sqrt(d)),
                               "bias": np.zeros((4 * d,), np.float32)})
    return params


def lstm_step(layers, x, h, c):
    """x: [B, d]; h, c: [L, B, d]. Returns (out [B, d], h', c')."""
    new_h, new_c = [], []
    inp = x
    for li, p in enumerate(layers):
        gates = inp @ p["wx"] + h[li] @ p["wh"] + p["bias"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c[li] + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        new_h.append(h_new)
        new_c.append(c_new)
        inp = h_new
    return inp, torch.stack(new_h), torch.stack(new_c)


def tdt_decode(dec_params, cfg: ParakeetConfig, encoded, enc_len, max_tokens: int,
               check_steps: int = TDT_CHECK_STEPS, loop: Optional[dict] = None):
    """Batched TDT greedy decode on the device.

    encoded: [B, T, enc_hidden]; enc_len: [B]. Returns (tokens
    [B, max_tokens] int32 (-1 padded), logprobs, n_tokens [B]). Steps run in
    chunks of ``check_steps``; before each chunk the host reads
    ``any(active)`` (one read a chunk, the loop's only sync). ``loop``, if
    given, receives the steps run and the reads."""
    b, t_max, _ = encoded.shape
    dev = encoded.device
    d = cfg.decoder_hidden
    nl = cfg.decoder_layers
    blank = cfg.blank_token_id
    durations = torch.tensor(cfg.duration_bins, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    enc_len = enc_len.to(dev, torch.int32)

    enc_proj = linear(encoded, dec_params["joint_enc"])        # [B, T, J] once

    def pred_out(token, h, c):
        emb = dec_params["embed"][token.long()]                 # [B, d]
        out, h, c = lstm_step(dec_params["lstm"], emb, h, c)
        return linear(out, dec_params["joint_pred"]), h, c      # [B, J]

    h = encoded.new_zeros((nl, b, d))
    c = encoded.new_zeros((nl, b, d))
    pred, h, c = pred_out(torch.full((b,), blank, dtype=torch.int32, device=dev), h, c)

    tokens = torch.full((b, max_tokens), -1, dtype=torch.int32, device=dev)
    lps = torch.zeros((b, max_tokens), dtype=torch.float32, device=dev)
    t = torch.zeros((b,), dtype=torch.int32, device=dev)
    n = torch.zeros((b,), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    blank_t = torch.full((), blank, dtype=torch.int32, device=dev)

    steps = reads = 0
    while True:
        reads += 1
        if not bool(((t < enc_len) & (n < max_tokens)).any()):
            break
        for _ in range(check_steps):
            active = (t < enc_len) & (n < max_tokens)
            enc_t = enc_proj[rows, t.clamp(0, t_max - 1)]       # [B, J]
            joint = linear(torch.relu(enc_t + pred), dec_params["joint_out"])
            tok_logits = joint[:, : cfg.vocab_size + 1].float()
            dur_logits = joint[:, cfg.vocab_size + 1:].float()

            tok = tok_logits.argmax(dim=-1).to(torch.int32)
            is_blank = tok == blank
            dur = durations[dur_logits.argmax(dim=-1)]

            # time advance: blank → +1; token → max(duration, 1)
            advance = torch.where(is_blank, one, torch.clamp(dur, min=1))
            t = torch.where(active, t + advance, t)

            # emit text tokens only
            emit = active & ~is_blank & (tok >= cfg.first_text_token_id)
            logp = torch.log_softmax(tok_logits, dim=-1)[rows, tok.long()]
            n_safe = n.clamp(0, max_tokens - 1).long()
            tokens[rows, n_safe] = torch.where(emit, tok, tokens[rows, n_safe])
            lps[rows, n_safe] = torch.where(emit, logp, lps[rows, n_safe])
            n = torch.where(emit, n + 1, n)

            # the LSTM advances on every non-blank (even filtered control tokens)
            keep = active & ~is_blank
            pred_new, h_new, c_new = pred_out(torch.where(keep, tok, blank_t), h, c)
            h = torch.where(keep[None, :, None], h_new, h)
            c = torch.where(keep[None, :, None], c_new, c)
            pred = torch.where(keep[:, None], pred_new, pred)
            steps += 1
    if loop is not None:
        loop.update(steps=steps, reads=reads)
    return tokens, lps, n


class ParakeetASR(SpeechRecognitionModel):
    """Parakeet-TDT 0.6B batch ASR on one device (the card unless the caller
    asks for the CPU)."""

    def __init__(self, cfg: ParakeetConfig, encoder_params, decoder_params,
                 tokenizer=None, dtype: torch.dtype = torch.bfloat16,
                 buckets_s: Sequence[int] = PARAKEET_BUCKETS_S, *, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.tokenizer = tokenizer  # SentencePieceModel
        self.encoder_params = params_from_jax(encoder_params, self.device, dtype)
        self.decoder_params = params_from_jax(decoder_params, self.device, dtype)
        self._buckets_s = tuple(buckets_s)
        self._loaded = True
        #: the last decode's steps and host reads
        self.last_loop: dict = {}

    @classmethod
    def init_random(cls, cfg: ParakeetConfig = CONFIG_06B, seed: int = 0,
                    dtype: torch.dtype = torch.bfloat16, *, device="cuda", **kw) -> "ParakeetASR":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_encoder_params(gen, cfg), init_decoder_params(gen, cfg),
                   dtype=dtype, device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "nvidia/parakeet-tdt-0.6b-v3",
                        cache_dir=None, offline_mode: bool = False,
                        progress_handler=None, dtype: torch.dtype = torch.bfloat16,
                        **kw) -> "ParakeetASR":
        """A checkpoint from a directory, a cached snapshot or a fetch (``core/hub.py``)."""
        from ...core.hub import download_weights
        from .convert import load_parakeet_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode,
                                     patterns=("*.safetensors", "*.json", "*.nemo", "*.model", "*.txt"))
        cfg, enc, dec, tokenizer = load_parakeet_checkpoint(model_dir)
        return cls(cfg, enc, dec, tokenizer=tokenizer, dtype=dtype, **kw)

    # ------------------------------------------------------------------ #

    def _bucket_samples(self, n: int) -> int:
        for s in self._buckets_s:
            if n <= s * self.cfg.sample_rate:
                return s * self.cfg.sample_rate
        return self._buckets_s[-1] * self.cfg.sample_rate

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16000, **kw) -> TranscriptionResult:
        return self.transcribe_batch([audio], sample_rate=sample_rate, **kw)[0]

    def prepare(self, audios: Sequence[np.ndarray]):
        """Host prep of a batch, as in the reference: (padded audio [B, L]
        fp32 on the device, valid mel frames [B], mel frames, the bucket in
        samples). Every clip is cut at and zero-extended to the batch's
        bucket. The bucket is part of the function: the subsampling convs'
        last valid frames read the frames past a clip's end, which are
        ReLU(bias) when computed from the padding and zero when there is
        none, and the bucket also sets ``max_tokens``."""
        bucket = max(self._bucket_samples(len(a)) for a in audios)
        n_frames = nemo_num_frames(self.cfg, bucket)
        need = (n_frames - 1) * self.cfg.hop_length + self.cfg.n_fft
        batch = np.zeros((len(audios), need), np.float32)
        n_valid = np.zeros(len(audios), np.int32)
        for i, a in enumerate(audios):
            padded, n_f = prepare_nemo_audio(a[:bucket], self.cfg)
            batch[i, : min(len(padded), need)] = padded[:need]
            n_valid[i] = n_f
        return (torch.from_numpy(batch).to(self.device), torch.from_numpy(n_valid).to(self.device),
                n_frames, bucket)

    @torch.inference_mode()
    def run(self, padded, n_valid, n_frames: int, max_tokens: int):
        """mel → encoder → TDT decode on the device: (tokens, logprobs, n)."""
        mel, n_f = nemo_log_mel(padded, n_valid, self.cfg, n_frames)
        encoded, n_out = encode(self.encoder_params, mel.to(self.dtype), n_f, self.cfg)
        loop: dict = {}
        out = tdt_decode(self.decoder_params, self.cfg, encoded, n_out, max_tokens, loop=loop)
        self.last_loop = loop
        return out

    def transcribe_batch(self, audios: Sequence[np.ndarray], sample_rate: int = 16000,
                         max_tokens: Optional[int] = None, **kw) -> List[TranscriptionResult]:
        t0 = time.perf_counter()
        if sample_rate != self.cfg.sample_rate:
            from ...audio.resample import resample

            audios = [resample(a.astype(np.float32), sample_rate, self.cfg.sample_rate) for a in audios]
        durations = [len(a) / self.cfg.sample_rate for a in audios]
        padded, n_valid, n_frames, bucket = self.prepare(audios)

        if max_tokens is None:
            # ~12 tokens/s upper bound, read from the bucket as in the reference
            max_tokens = min(1024, max(64, int(np.ceil(bucket / self.cfg.sample_rate * 12 / 64)) * 64))

        tokens, lps, n = self.run(padded, n_valid, n_frames, max_tokens)
        tokens, lps, n = tokens.cpu().numpy(), lps.cpu().numpy(), n.cpu().numpy()
        elapsed = time.perf_counter() - t0

        results = []
        for i in range(len(audios)):
            ids = tokens[i, : n[i]].tolist()
            text = self.tokenizer.decode(ids) if self.tokenizer else " ".join(map(str, ids))
            conf = float(min(1.0, np.exp(lps[i, : n[i]].mean()))) if n[i] else 0.0
            results.append(TranscriptionResult(
                text=text, confidence=conf, duration=durations[i],
                processing_time=elapsed / len(audios),
            ))
        return results

    def warm_up(self) -> None:
        self.transcribe(np.zeros(self.cfg.sample_rate, np.float32))

    def unload(self) -> None:
        self.encoder_params = None
        self.decoder_params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded
