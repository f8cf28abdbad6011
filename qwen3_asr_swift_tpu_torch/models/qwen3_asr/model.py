"""Qwen3-ASR batched transcription — port of
``qwen3_asr_swift_tpu/models/qwen3_asr/model.py``.

The path of one ``transcribe_batch``:

1. host staging: resample, reflect-pad, bucket, encode to the wire format
   and copy to the device (:meth:`Qwen3ASR.prestage`);
2. on-device wire decode and log-mel, then the windowed encoder, batched
   over clips (:meth:`Qwen3ASR._encode`);
3. the static prompt ``[prefix | audio | suffix]`` prefilled into a static
   KV cache (:meth:`Qwen3ASR._gen_start`);
4. decode in chunks (:meth:`Qwen3ASR._gen_chunk`), greedy or sampled
   (temperature, top-k, the repetition and n-gram penalties). The host
   fetches ``done`` only at chunk boundaries, never per token. With
   ``SamplingOptions(beam=K)`` steps 3-4 are beam search instead
   (``beam.py``), under the dispatch gate's latency lane.

The state after ``_gen_start`` and after every chunk matches the
reference's exactly: ``tokens`` start as ``pad_id``, rows that are done
write pads and logprob 0, and ``n_gen = sum(tokens != pad_id)``. Where the
reference's device ``while_loop`` stops as soon as every row is done, the
port finishes the current chunk; the extra steps write pads into rows
that are done, so the outputs are the same.

With a ``dispatch_gate`` (``serving/dispatch.DispatchGate``) every encode
and decode chunk holds a gate slot and syncs before releasing it; a
request's first chunk rides the latency lane, and a single gated clip runs
encode, prefill and its first chunk under one latency slot.

Not ported yet: the ``groupdot`` compute mode, sharding, and
``from_pretrained``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...audio.companding import (dpcm4_decode, dpcm4_encode_np, mulaw_decode, mulaw_encode_np,
                                 pcm4_decode, pcm4_encode_np)
from ...audio.resample import resample
from ...core.protocols import SpeechRecognitionModel
from ...core.types import ModelMemoryStats, TranscriptionResult
from ...core.params import init_random_params, param_bytes, params_from_jax
from ...device import resolve_device
from ...ops.kv_cache import KVCache
from ...ops.mel import MelConfig, log_mel_kernel, num_frames, reflect_pad_np
from ...ops.nn import embedding_lookup, tied_lm_head
from ...ops.quant import dequantize_tree
from ...ops.sampling import (SamplingOptions, check_supported, force_eos_after,
                             log_softmax_confidence, sample_token)
from ...serving.dispatch import BULK, LATENCY, gate_slot
from ...tokenizers.bpe import BPETokenizer
from .beam import beam_search
from .config import CONFIG_SMALL, Qwen3ASRConfig
from .decoder import decode_step, fuse_for_inference, make_cache, prefill
from .encoder import encode

# Audio buckets in seconds — multiples of 8 s so mel frames tile the
# 800-frame attention window exactly.
ASR_AUDIO_BUCKETS_S = (8, 16, 32, 64, 128, 320, 640, 1200)
_WIRES = ("mulaw", "pcm4", "dpcm4")


def _round_block(n: int, quantum: int = 32) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


@dataclasses.dataclass
class _StagedBatch:
    """A batch whose wire payload is already on the device."""

    padded: torch.Tensor
    scales: Optional[torch.Tensor]   # pcm4/dpcm4 block scales, else None
    n_valid: torch.Tensor            # [B] valid mel frames
    bucket: int                      # mel frames of the bucket
    b: int
    n_req: int
    durations: List[float]


@dataclasses.dataclass
class _Prompt:
    prefix_ids: torch.Tensor   # [B, prefix_block]
    prefix_len: torch.Tensor   # [B]
    suffix_ids: torch.Tensor   # [B, suffix_block]
    suffix_len: torch.Tensor   # [B]


@dataclasses.dataclass
class DecodeState:
    """What the reference carries through its decode ``while_loop``."""

    step: int
    tokens: torch.Tensor       # [B, max_new] int64, pad-filled
    logprobs: torch.Tensor     # [B, max_new] fp32
    cache: KVCache
    done: torch.Tensor         # [B] bool
    last_tok: torch.Tensor     # [B] int64
    generator: Optional[torch.Generator] = None   # temperature noise


class Qwen3ASR(SpeechRecognitionModel):
    """Qwen3-ASR (0.6B / 1.7B) batch transcription on one device.

    ``encoder_params``/``decoder_params`` are parameter trees in the JAX
    package's layout (numpy or JAX arrays, or tensors); they are carried
    onto ``device`` by :func:`core.params.params_from_jax`.

    ``quant_compute``: ``"packed"`` keeps packed 2/4/8-bit decoder weights
    and runs decode-shaped products through kernel K1; ``"dequant"``
    materializes them to dense ``dtype`` at load (same quantized values).
    ``kv_dtype=torch.int8`` quantizes the KV cache per slot, read at decode
    by kernel K3. ``wire_dtype``: ``np.float32``, ``np.int16``, ``"mulaw"``,
    ``"pcm4"`` or ``"dpcm4"``."""

    def __init__(
        self,
        cfg: Qwen3ASRConfig,
        encoder_params,
        decoder_params,
        *,
        device="cuda",
        tokenizer: Optional[BPETokenizer] = None,
        dtype: torch.dtype = torch.bfloat16,
        mel_cfg: MelConfig = MelConfig(),
        audio_buckets_s: Sequence[int] = ASR_AUDIO_BUCKETS_S,
        wire_dtype=np.float32,
        kv_dtype: Optional[torch.dtype] = None,
        decode_chunk_tokens: Optional[int] = None,
        quant_compute: str = "packed",
        dispatch_gate=None,
        first_chunk_tokens: int = 8,
    ):
        if quant_compute == "groupdot":
            raise NotImplementedError("quant_compute='groupdot' is not ported yet")
        if quant_compute not in ("packed", "dequant"):
            raise ValueError(f"unknown quant_compute {quant_compute!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.kv_dtype = kv_dtype or dtype
        self.quant_compute = quant_compute
        self.dispatch_gate = dispatch_gate
        self.first_chunk_tokens = first_chunk_tokens
        self.decode_chunk_tokens = decode_chunk_tokens
        self.mel_cfg = mel_cfg
        self.tokenizer = tokenizer
        if isinstance(wire_dtype, str) and wire_dtype not in _WIRES:
            raise ValueError(f"unknown wire format {wire_dtype!r}")
        self._wire_name = wire_dtype if isinstance(wire_dtype, str) else None
        self._wire4 = wire_dtype in ("pcm4", "dpcm4")
        self.wire_dtype = np.dtype(
            np.uint8 if self._wire4 else (np.int8 if wire_dtype == "mulaw" else wire_dtype))
        self._audio_buckets_s = tuple(audio_buckets_s)
        bad = [s for s in self._audio_buckets_s if (s * 100) % cfg.encoder.n_window_infer]
        if bad:
            win_s = cfg.encoder.n_window_infer / 100
            raise ValueError(
                f"audio_buckets_s {bad} are not multiples of the encoder attention "
                f"window ({cfg.encoder.n_window_infer} mel frames = {win_s:g} s)")

        self.encoder_params = params_from_jax(encoder_params, self.device, dtype)
        dec = params_from_jax(decoder_params, self.device, dtype)
        if quant_compute == "dequant":
            dec = dequantize_tree(dec, cfg.decoder.bits, cfg.decoder.group_size, dtype)
        self.decoder_params = fuse_for_inference(dec, cfg.decoder)
        self._loaded = True

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def from_params(cls, cfg: Qwen3ASRConfig, enc, dec, **kw) -> "Qwen3ASR":
        """Build from parameter trees in the JAX package's layout (e.g.
        the reference's ``init_encoder_params``/``quantize_tree`` output)."""
        return cls(cfg, enc, dec, **kw)

    @classmethod
    def init_random(cls, cfg: Qwen3ASRConfig = CONFIG_SMALL, seed: int = 0, *,
                    device="cuda", dtype: torch.dtype = torch.bfloat16,
                    quant_bits: Optional[int] = None, **kw) -> "Qwen3ASR":
        """Random weights drawn with numpy from ``seed``; ``quant_bits``
        packs the decoder linears and embedding (MLX group 64)."""
        enc, dec = init_random_params(cfg, seed, quant_bits)
        if quant_bits:
            cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
                cfg.decoder, bits=quant_bits, group_size=64))
        return cls(cfg, enc, dec, device=device, dtype=dtype, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str, cache_dir=None, offline_mode: bool = False,
                        progress_handler=None, **kwargs):
        raise NotImplementedError("loading published checkpoints is not ported yet")

    # ------------------------------------------------------------------ #
    # host staging
    # ------------------------------------------------------------------ #

    def _frames_bucket(self, n_valid: int) -> int:
        per_s = self.mel_cfg.sample_rate // self.mel_cfg.hop_length
        for s in self._audio_buckets_s:
            if n_valid <= s * per_s:
                return s * per_s
        return self._audio_buckets_s[-1] * per_s

    def _prepare_audio(self, audio: np.ndarray, sample_rate: int):
        """Resample + reflect-pad + zero-extend to the bucket. Returns
        (padded audio [L], n_valid_frames, bucket frames)."""
        if sample_rate != self.mel_cfg.sample_rate:
            audio = resample(audio.astype(np.float32), sample_rate, self.mel_cfg.sample_rate)
        audio = np.atleast_1d(np.asarray(audio, np.float32))
        if len(audio) < 2:
            audio = np.pad(audio, (0, 2 - len(audio)))
        n_valid = num_frames(self.mel_cfg, len(audio))
        bucket = self._frames_bucket(n_valid)
        n_valid = min(n_valid, bucket)  # longer than the largest bucket: cut
        padded = reflect_pad_np(audio, self.mel_cfg.n_fft // 2)
        need = (bucket - 1) * self.mel_cfg.hop_length + self.mel_cfg.n_fft
        if len(padded) < need:
            padded = np.pad(padded, (0, need - len(padded)))
        return padded[:need], n_valid, bucket

    def prestage(self, audios: Sequence[np.ndarray], sample_rate: int = 16000) -> _StagedBatch:
        """Host preparation and the copy to the device, apart from compute."""
        durations = [len(a) / sample_rate for a in audios]
        prepared = [self._prepare_audio(a, sample_rate) for a in audios]
        bucket = max(p[2] for p in prepared)
        need = (bucket - 1) * self.mel_cfg.hop_length + self.mel_cfg.n_fft
        pad_to = 2 * 128 if self._wire4 else 1  # pcm4 block alignment
        need_pad = ((need + pad_to - 1) // pad_to) * pad_to
        b = len(prepared)
        stage = np.zeros((b, need_pad), np.float32)
        for i, (clip, _, _) in enumerate(prepared):
            stage[i, : len(clip)] = clip[:need]
        scales = None
        if self._wire4:
            enc4 = dpcm4_encode_np if self._wire_name == "dpcm4" else pcm4_encode_np
            stage, scales = enc4(stage)
        elif self.wire_dtype == np.int8:
            stage = mulaw_encode_np(stage)
        elif self.wire_dtype == np.int16:
            stage = np.round(np.clip(stage, -1.0, 1.0) * 32767.0).astype(np.int16)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        n_valid = np.array([p[1] for p in prepared], np.int64)
        return _StagedBatch(padded=put(stage), scales=put(scales) if scales is not None else None,
                            n_valid=put(n_valid), bucket=bucket, b=b, n_req=len(audios),
                            durations=durations)

    # ------------------------------------------------------------------ #
    # device stages
    # ------------------------------------------------------------------ #

    def _wire_to_mel(self, padded, n_valid, n_frames: int, scales=None) -> torch.Tensor:
        if scales is not None:
            dec4 = dpcm4_decode if self._wire_name == "dpcm4" else pcm4_decode
            padded = dec4(padded, scales)
        elif padded.dtype == torch.int8:
            padded = mulaw_decode(padded)
        elif padded.dtype == torch.int16:
            padded = padded.float() / 32767.0
        return log_mel_kernel(padded, n_valid, self.mel_cfg, n_frames).to(self.dtype)

    def _encode(self, st: _StagedBatch):
        """wire → mel → encoder: (audio tokens [B, a_pad, out], n_audio [B])."""
        mel = self._wire_to_mel(st.padded, st.n_valid, st.bucket, st.scales)
        return encode(self.encoder_params, mel, st.n_valid, self.cfg.encoder)

    def _build_prompt(self, language: Optional[str], context: Optional[str]):
        """Chat-template ids around the audio block."""
        c = self.cfg
        enc = (lambda s: self.tokenizer.encode(s)) if self.tokenizer else (lambda s: [])
        prefix = [c.im_start_id, c.system_id, c.newline_id]
        if context:
            prefix += enc(context)
        prefix += [c.eos_id, c.newline_id]
        prefix += [c.im_start_id, c.user_id, c.newline_id, c.audio_start_id]
        suffix = [c.audio_end_id, c.eos_id, c.newline_id]
        suffix += [c.im_start_id, c.assistant_id, c.newline_id]
        if language:
            suffix += enc(f"language {language}")
        suffix += [c.asr_text_id]
        return prefix, suffix

    def _prompt(self, b: int, language, context) -> _Prompt:
        prefix, suffix = self._build_prompt(language, context)
        pb, sb = _round_block(len(prefix)), _round_block(len(suffix))
        prefix_ids = np.zeros((b, pb), np.int64)
        prefix_ids[:, : len(prefix)] = prefix
        suffix_ids = np.zeros((b, sb), np.int64)
        suffix_ids[:, : len(suffix)] = suffix
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return _Prompt(put(prefix_ids), put(np.full((b,), len(prefix), np.int64)),
                       put(suffix_ids), put(np.full((b,), len(suffix), np.int64)))

    @torch.inference_mode()
    def _prefill(self, audio_tokens, n_audio, prompt: _Prompt, cache_len: int, kv_dtype):
        """Embed the static prompt ``[prefix | audio | suffix]`` and prefill
        a new ``cache_len``-row cache. Returns (logits of each row's last
        prompt token fp32 [B, V], cache, prompt valid map [B, T])."""
        dcfg = self.cfg.decoder
        dev = self.device
        b, pb = prompt.prefix_ids.shape
        sb = prompt.suffix_ids.shape[1]
        a_pad = audio_tokens.shape[1]
        table = self.decoder_params["embed_tokens"]
        emb_prefix = embedding_lookup(table, prompt.prefix_ids, dcfg.hidden_size)
        emb_suffix = embedding_lookup(table, prompt.suffix_ids, dcfg.hidden_size)
        embeds = torch.cat([emb_prefix, audio_tokens.to(emb_prefix.dtype), emb_suffix], dim=1)
        valid = torch.cat([
            torch.arange(pb, device=dev)[None] < prompt.prefix_len[:, None],
            torch.arange(a_pad, device=dev)[None] < n_audio[:, None],
            torch.arange(sb, device=dev)[None] < prompt.suffix_len[:, None],
        ], dim=1)
        cache = make_cache(dcfg, b, cache_len, kv_dtype, dev)
        hidden, cache = prefill(self.decoder_params, dcfg, embeds, valid, cache)
        last_idx = pb + a_pad + prompt.suffix_len - 1
        logits = tied_lm_head(hidden[torch.arange(b, device=dev), last_idx], table)
        return logits, cache, valid

    @torch.inference_mode()
    def _gen_start(self, audio_tokens, n_audio, prompt: _Prompt, max_new: int,
                   opts: SamplingOptions, generator: Optional[torch.Generator] = None
                   ) -> DecodeState:
        """Prefill a cache with room for ``max_new`` tokens, pick token 0."""
        t_prompt = prompt.prefix_ids.shape[1] + audio_tokens.shape[1] + prompt.suffix_ids.shape[1]
        logits, cache, _ = self._prefill(audio_tokens, n_audio, prompt, t_prompt + max_new,
                                         self.kv_dtype)
        b, dev = logits.shape[0], self.device
        tokens = torch.full((b, max_new), self.cfg.pad_id, dtype=torch.int64, device=dev)
        logprobs = torch.zeros((b, max_new), dtype=torch.float32, device=dev)
        tok0 = sample_token(logits, opts, generator, tokens, 0)
        tokens[:, 0] = tok0
        logprobs[:, 0] = log_softmax_confidence(logits, tok0)
        return DecodeState(step=1, tokens=tokens, logprobs=logprobs, cache=cache,
                           done=tok0 == self.cfg.eos_id, last_tok=tok0, generator=generator)

    @torch.inference_mode()
    def _gen_chunk(self, state: DecodeState, end: int, opts: SamplingOptions) -> DecodeState:
        """Decode steps ``state.step .. end-1`` with no host sync."""
        pad, eos = self.cfg.pad_id, self.cfg.eos_id
        for step in range(state.step, end):
            logits, _ = decode_step(self.decoder_params, self.cfg.decoder, state.last_tok,
                                    state.cache)
            tok = sample_token(logits, opts, state.generator, state.tokens, step)
            tok = force_eos_after(tok, step, opts, eos)
            lp = log_softmax_confidence(logits, tok)
            tok = torch.where(state.done, torch.full_like(tok, pad), tok)
            state.tokens[:, step] = tok  # rows already done write the pad they hold
            state.logprobs[:, step] = torch.where(state.done, torch.zeros_like(lp), lp)
            state.done = state.done | (tok == eos)
            state.last_tok = tok
        state.step = max(state.step, end)
        return state

    @staticmethod
    def _all_done(state: DecodeState) -> bool:
        return bool(state.done.all().item())  # host sync: chunk boundaries only

    def _generate(self, st: _StagedBatch, prompt_args, opts: SamplingOptions, priority,
                  generator: torch.Generator, timings=None):
        """Encode + prefill + chunked decode (or beam search), under the
        dispatch gate if any. Returns (tokens [B, max_new], logprobs)."""
        gate = self.dispatch_gate
        max_new = opts.max_tokens
        chunk = self.decode_chunk_tokens or max_new
        fused = gate is not None and st.n_req == 1 and timings is None and opts.beam <= 1
        enc_prio = priority if priority is not None else (LATENCY if st.n_req == 1 else BULK)
        first_prio = LATENCY if priority is None else priority
        cont_prio = BULK if priority is None else priority
        t0 = time.perf_counter()

        def encode():
            with torch.inference_mode():
                audio = self._encode(st)
            if timings is not None or (gate is not None and not fused):
                self._sync()  # a gated encode completes before its slot is released
            if timings is not None:
                timings["encode"] = time.perf_counter() - t0
            return audio

        def start(audio):
            return self._gen_start(*audio, self._prompt(st.b, *prompt_args), max_new, opts,
                                   generator)

        if opts.beam > 1:
            # one monolithic search under the latency lane, as the reference
            with gate_slot(gate, enc_prio):
                audio = encode()
            with gate_slot(gate, LATENCY if priority is None else priority):
                out = beam_search(self, *audio, self._prompt(st.b, *prompt_args), max_new,
                                  opts.beam, opts.length_penalty)
                if gate is not None:
                    self._sync()  # the search completes before its slot is released
            return out
        if gate is None:
            state = start(encode())
            first_end = min(1 + chunk, max_new)
            self._gen_chunk(state, first_end, opts)
        else:
            first_end = min(max(self.first_chunk_tokens, 1), max_new)
            if fused:  # one latency slot: encode, prefill and the first chunk
                with gate.slot(first_prio):
                    state = start(encode())
                    self._gen_chunk(state, first_end, opts)
                    done = self._all_done(state)
            else:
                with gate.slot(enc_prio):
                    audio = encode()
                with gate.slot(first_prio):
                    state = start(audio)
                    self._gen_chunk(state, first_end, opts)
                    done = self._all_done(state)
        step = first_end
        while step < max_new:
            end = min(step + chunk, max_new)
            if gate is None:
                if self._all_done(state):
                    break
                self._gen_chunk(state, end, opts)
            else:
                if done:
                    break
                with gate.slot(cont_prio):
                    self._gen_chunk(state, end, opts)
                    done = self._all_done(state)
            step = end
        return state.tokens, state.logprobs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # public inference
    # ------------------------------------------------------------------ #

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16000,
                   language: Optional[str] = None, context: Optional[str] = None,
                   max_tokens: int = 448, options: Optional[SamplingOptions] = None,
                   priority: Optional[int] = None, timings: Optional[dict] = None,
                   **kwargs) -> TranscriptionResult:
        return self.transcribe_batch(
            [audio], sample_rate=sample_rate, language=language, context=context,
            max_tokens=max_tokens, options=options, priority=priority, timings=timings)[0]

    def transcribe_batch(self, audios: Optional[Sequence[np.ndarray]] = None,
                         sample_rate: int = 16000, language: Optional[str] = None,
                         context: Optional[str] = None, max_tokens: int = 448,
                         options: Optional[SamplingOptions] = None, seed: int = 0,
                         timings: Optional[dict] = None, priority: Optional[int] = None,
                         prestaged: Optional[_StagedBatch] = None) -> List[TranscriptionResult]:
        """Transcribe a batch: one audio bucket (the largest needed), one
        prompt shape. ``seed`` seeds the ``torch.Generator`` that
        temperature sampling draws from. ``timings`` receives per-stage wall
        times ({host_prep, encode, generate, postprocess} s) with a device
        sync at each boundary. ``prestaged`` is a :meth:`prestage` handle."""
        t_start = time.perf_counter()
        opts = options or SamplingOptions(max_tokens=max_tokens)
        check_supported(opts)
        st = prestaged if prestaged is not None else self.prestage(audios, sample_rate)
        if timings is not None:
            self._sync()
            timings["host_prep"] = time.perf_counter() - t_start
        t_gen = time.perf_counter()
        generator = torch.Generator(device=self.device).manual_seed(seed)
        tokens, logprobs = self._generate(st, (language, context), opts, priority, generator,
                                          timings)
        if timings is not None:
            self._sync()
            timings["generate"] = time.perf_counter() - t_gen - timings.get("encode", 0.0)
        t_post = time.perf_counter()
        n_gen = (tokens != self.cfg.pad_id).sum(dim=1)
        tokens = tokens.to(torch.int32).cpu().numpy()
        logprobs = logprobs.cpu().numpy()
        n_gen = n_gen.cpu().numpy()
        if timings is not None:
            timings["postprocess"] = time.perf_counter() - t_post
        return self._finalize(tokens, n_gen, logprobs, st.n_req, st.durations, language,
                              time.perf_counter() - t_start)

    def _finalize(self, tokens, n_gen, logprobs, n_req, durations, language,
                  elapsed) -> List[TranscriptionResult]:
        results = []
        for i in range(n_req):
            ids = [t for t in tokens[i, : n_gen[i]].tolist() if t != self.cfg.eos_id]
            if self.tokenizer:
                text = self.tokenizer.decode(ids, skip_special=True)
                if "<asr_text>" in text:
                    text = text.split("<asr_text>", 1)[1].strip()
                text = text.strip()
            else:
                text = " ".join(map(str, ids))
            lp = logprobs[i, : max(n_gen[i], 1)]
            conf = float(np.exp(lp.mean())) if n_gen[i] else 0.0
            results.append(TranscriptionResult(
                text=text, language=language, confidence=conf,
                duration=durations[i], processing_time=elapsed / n_req))
        return results

    def warm_up(self, max_tokens: int = 448, buckets_s: Optional[Sequence[int]] = None) -> None:
        """Run the shapes real requests use once (kernel build, allocator)."""
        for s_bucket in (buckets_s or self._audio_buckets_s[:1]):
            silent = np.zeros(self.mel_cfg.sample_rate * int(s_bucket), np.float32)
            self.transcribe(silent, max_tokens=max_tokens)

    def unload(self) -> None:
        self.encoder_params = None
        self.decoder_params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def memory_stats(self) -> ModelMemoryStats:
        return ModelMemoryStats(
            parameter_bytes=param_bytes(self.encoder_params) + param_bytes(self.decoder_params))
