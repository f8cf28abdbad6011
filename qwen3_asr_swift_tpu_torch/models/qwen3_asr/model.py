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
   fetches ``done`` only at chunk boundaries, never per token. A greedy
   decode on the card captures its second step as a CUDA graph and replays
   it for the batch's later steps (:func:`uses_step_graph`), so that the
   host issues one launch a step and not every kernel of it. With
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

:meth:`Qwen3ASR.shard` spreads the model over a (dp, tp) mesh of ranks
(``parallel/``), one process a device, every rank calling
``transcribe_batch`` with the same batch (SPMD) and getting every result:

- dp splits the batch into contiguous row ranges, padded with copies of
  the last clip so that dp divides it; each rank stages, encodes and
  decodes its rows, and the tokens and logprobs are gathered over dp;
- tp cuts the encoder and the unfused decoder by the rule tables: K1 runs
  on each rank's packed shard and K3 on its kv heads, the logits are
  gathered before sampling, so every rank of a tp row picks the same
  tokens;
- on a dp mesh one utterance of two or more windows takes the
  sequence-parallel encode instead (the float and µ-law wires);
- beam search is refused on dp meshes, group-dot on any mesh, as the
  reference refuses them. Temperature draws are taken for the whole
  request and sliced to the rank's rows, so a dp run samples what one
  device samples.

:meth:`Qwen3ASR.from_pretrained` loads a checkpoint from a local directory,
from the cache by model id (offline too) or by fetch (``core/hub.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...audio.companding import (dpcm4_decode, dpcm4_encode_np, mulaw_decode, mulaw_encode_np,
                                 pcm4_decode, pcm4_encode_np)
from ...audio.resample import resample
from ...core import trace
from ...core.logging import inference as log
from ...core.protocols import SpeechRecognitionModel
from ...core.types import ModelMemoryStats, TranscriptionResult
from ...core.params import init_random_params, params_from_jax
from ...core.weights import param_bytes
from ...device import resolve_device
from ...ops.kv_cache import KVCache
from ...ops.mel import MelConfig, log_mel_kernel, num_frames, reflect_pad_np
from ...ops.nn import embedding_lookup, tied_lm_head
from ...ops.quant import dequantize_tree, repack_tree_groupdot
from ...ops.sampling import (SamplingOptions, check_supported, force_eos_after,
                             log_softmax_confidence, sample_token)
from ...serving.dispatch import BULK, LATENCY, gate_slot
from ...tokenizers.bpe import BPETokenizer
from .beam import beam_search
from .config import CONFIG_SMALL, Qwen3ASRConfig, detect_config
from .decoder import (decode_step, fuse_for_inference, local_kv_heads, make_cache, prefill,
                      shard_decoder, tp_parts)
from .encoder import encode

# Audio buckets in seconds — multiples of 8 s so mel frames tile the
# 800-frame attention window exactly.
ASR_AUDIO_BUCKETS_S = (8, 16, 32, 64, 128, 320, 640, 1200)
_WIRES = ("mulaw", "pcm4", "dpcm4")


#: a greedy decode captures a step only with at least this many steps of its
#: budget left to replay (a capture costs about one eager step of the host)
GRAPH_MIN_STEPS = 8
#: one capture at a time in the process; a device-wide synchronize (``_sync``)
#: is invalid while another thread captures
_CAPTURE_LOCK = threading.Lock()
#: device → the side stream captures run on (under the lock)
_capture_streams: dict = {}


def uses_step_graph(device: torch.device, mesh, opts: SamplingOptions, step: int,
                    max_new: int) -> bool:
    """Whether decode step ``step`` of a ``max_new``-token budget is captured
    as a CUDA graph, then replayed for the batch's later steps: on a CUDA
    device, off any mesh, with a sampler that reads no generator and no
    history (greedy: no temperature, penalty or top-k; ``force_eos_after``
    is compared on the device), from the second step on (the first runs
    eagerly and warms up what capture needs), and with
    :data:`GRAPH_MIN_STEPS` steps of the budget left to replay."""
    return (device.type == "cuda" and mesh is None and opts.is_greedy and step >= 2
            and max_new - step >= GRAPH_MIN_STEPS)


def _round_block(n: int, quantum: int = 32) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


@dataclasses.dataclass
class _StagedBatch:
    """A batch whose wire payload is already on the device (this rank's
    rows of it on a dp mesh)."""

    padded: torch.Tensor
    scales: Optional[torch.Tensor]   # pcm4/dpcm4 block scales, else None
    n_valid: torch.Tensor            # [B] valid mel frames
    bucket: int                      # mel frames of the bucket
    b: int                           # rows on this device
    n_req: int
    durations: List[float]
    use_sp: bool = False             # one clip, sequence-parallel encode
    dp: int = 1                      # dp ranks the rows are split over
    rows: Optional[slice] = None     # this rank's rows of the padded batch
    b_global: int = 0                # the padded batch over every dp rank


@dataclasses.dataclass
class _Prompt:
    prefix_ids: torch.Tensor   # [B, prefix_block]
    prefix_len: torch.Tensor   # [B]
    suffix_ids: torch.Tensor   # [B, suffix_block]
    suffix_len: torch.Tensor   # [B]


@dataclasses.dataclass
class StepGraph:
    """A greedy decode step captured as a CUDA graph (:meth:`Qwen3ASR._capture`):
    the step index and cache row that it reads and advances, on the device,
    and the kernel launches that one replay makes, by counter."""

    step: torch.Tensor         # int64 [1]: the step the next replay decodes
    cursor: torch.Tensor       # int64 [1]: the cache row it writes
    graph: object = None       # torch.cuda.CUDAGraph
    launches: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def at(cls, state: "DecodeState", step: int) -> "StepGraph":
        """Step ``step`` of ``state``, its cache row ``state.cache.cursor``."""
        def full(v):
            return torch.full((1,), v, dtype=torch.int64, device=state.tokens.device)

        return cls(full(step), full(state.cache.cursor))

    def replay(self, state: "DecodeState") -> None:
        """Run the next step of ``state`` and count it and its launches."""
        self.graph.replay()
        trace.add_held(self.launches)
        trace.GRAPH_REPLAYS.add()
        state.cache.cursor += 1


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
    #: (first row, rows of the request) on a dp rank: temperature noise is
    #: drawn for the request and this rank's rows kept (ops/sampling.py)
    noise_rows: Optional[tuple] = None
    #: the batch's captured step, from the step captured on; dropped with the
    #: state (the model keeps its CUDA graph, for the pool, until the thread's
    #: next capture)
    graph: Optional[StepGraph] = None
    #: ``done.all()`` as the last chunk left it (bool [], on the device)
    all_done: Optional[torch.Tensor] = None


class Qwen3ASR(SpeechRecognitionModel):
    """Qwen3-ASR (0.6B / 1.7B) batch transcription on one device.

    ``encoder_params``/``decoder_params`` are parameter trees in the JAX
    package's layout (numpy or JAX arrays, or tensors); they are carried
    onto ``device`` by :func:`core.params.params_from_jax`.

    ``quant_compute``: ``"packed"`` keeps packed 2/4/8-bit decoder weights
    and runs decode-shaped products through kernel K1; ``"dequant"``
    materializes them to dense ``dtype`` at load (same quantized values);
    ``"groupdot"`` unpacks the linears' codes once to int8 and multiplies
    them with int8-quantized activations group by group
    (``ops/quant.py::quant_matmul_groupdot``), while the packed embedding
    stays packed, so the LM head still runs K1.
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
        if quant_compute not in ("packed", "dequant", "groupdot"):
            raise ValueError(f"unknown quant_compute {quant_compute!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.kv_dtype = kv_dtype or dtype
        self.quant_compute = quant_compute
        self.dispatch_gate = dispatch_gate
        self.first_chunk_tokens = first_chunk_tokens
        self.decode_chunk_tokens = decode_chunk_tokens
        #: the decode budget of a call that passes none (the batchers' and
        #: the realtime session's commits pass none)
        self.max_tokens = 448
        self.mel_cfg = mel_cfg
        self.tokenizer = tokenizer
        self._mesh = None  # set by shard()
        #: per thread, the last CUDA graph captured: the next capture shares
        #: its memory pool, and it is dropped then
        self._graphs = threading.local()
        #: introspection: the last staged batch's size, sharding, this
        #: device's rows and their shape
        self.last_staging: dict = {}
        #: decode steps (``decode_step`` calls) the last greedy or sampled
        #: generate ran
        self.last_loop = {"decode_steps": 0}
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
        if quant_compute == "groupdot":
            self.decoder_params = repack_tree_groupdot(self.decoder_params,
                                                       cfg.decoder.group_size)
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
    def from_pretrained(cls, model_id: str = "aufklarer/Qwen3-ASR-0.6B-MLX-4bit",
                        cache_dir=None, offline_mode: bool = False, progress_handler=None,
                        dtype: torch.dtype = torch.bfloat16, **kw) -> "Qwen3ASR":
        """Load a checkpoint in the published layout from a local directory
        (``*.safetensors``, and ``vocab.json``/``merges.txt`` for text; without
        them decode returns ids). The directory's name picks the size and the
        bits, as a model id does. A model id is found in the cache
        (``cache_dir``, ``QWEN3_CACHE_DIR``, offline too) or fetched
        (``core/hub.py``). ``kw`` go to the constructor (``device``,
        ``kv_dtype``, ...)."""
        from ...core.hub import download_weights
        from ...core.weights import load_safetensors
        from .convert import convert_decoder, convert_encoder

        if progress_handler:
            progress_handler(0.0, "Downloading model...")
        cfg = detect_config(model_id)
        model_dir = download_weights(
            model_id, cache_dir=cache_dir, offline_mode=offline_mode,
            additional_files=("vocab.json", "merges.txt", "tokenizer_config.json"),
            progress_handler=(lambda p: progress_handler(p * 0.8, "Downloading weights...")) if progress_handler else None,
        )
        if progress_handler:
            progress_handler(0.8, "Loading tokenizer...")
        tokenizer = None
        try:
            tokenizer = BPETokenizer.from_pretrained_dir(model_dir)
        except FileNotFoundError:
            log.warning("no tokenizer files in %s — decode will return ids", model_dir)
        if progress_handler:
            progress_handler(0.85, "Converting weights...")
        flat = load_safetensors(model_dir)
        enc = convert_encoder(flat, cfg)
        dec = convert_decoder(flat, cfg)
        if progress_handler:
            progress_handler(1.0, "Ready")
        return cls(cfg, enc, dec, tokenizer=tokenizer, dtype=dtype, **kw)

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

    def staging_buffer(self, audios: Sequence[np.ndarray], sample_rate: int = 16000):
        """The float32 buffer a batch is staged from, before the wire
        encoding: (buffer [B, samples of the bucket, padded to whole 4-bit
        wire blocks], [(padded clip, valid mel frames, bucket frames)])."""
        prepared = [self._prepare_audio(a, sample_rate) for a in audios]
        bucket = max(p[2] for p in prepared)
        need = (bucket - 1) * self.mel_cfg.hop_length + self.mel_cfg.n_fft
        pad_to = 2 * 128 if self._wire4 else 1  # pcm4 block alignment
        need_pad = ((need + pad_to - 1) // pad_to) * pad_to
        stage = np.zeros((len(prepared), need_pad), np.float32)
        for i, (clip, _, _) in enumerate(prepared):
            stage[i, : len(clip)] = clip[:need]
        return stage, prepared

    def prestage(self, audios: Sequence[np.ndarray], sample_rate: int = 16000) -> _StagedBatch:
        """Host preparation and the copy to the device, apart from compute.
        On a dp mesh the batch is padded with copies of the last clip so
        that dp divides it, and this rank copies only its rows; one clip of
        two or more encoder windows takes the sequence-parallel encode
        instead (every rank stages it)."""
        with trace.span("asr.prestage"):
            # in a call of its own, so that the span holds the freeing of
            # the staging buffers (tens of ms for a batch of long clips)
            return self._stage(audios, sample_rate)

    def _stage(self, audios: Sequence[np.ndarray], sample_rate: int) -> _StagedBatch:
        durations = [len(a) / sample_rate for a in audios]
        n_req = len(audios)
        mesh = self._mesh
        dp = mesh.dp if mesh is not None else 1
        if dp > 1 and n_req % dp:
            audios = list(audios) + [audios[-1]] * (dp - n_req % dp)
        stage, prepared = self.staging_buffer(audios, sample_rate)
        bucket = max(p[2] for p in prepared)
        use_sp = (n_req == 1 and dp > 1 and not self._wire4
                  and bucket >= 2 * self.cfg.encoder.n_window_infer)
        if use_sp:
            dp, stage, prepared = 1, stage[:1], prepared[:1]
        b_global = len(prepared)
        rows = slice(0, b_global)
        if dp > 1:
            from ...parallel import batch_sharding

            rows = batch_sharding(mesh, b_global)
        scales = None
        if self._wire4:
            enc4 = dpcm4_encode_np if self._wire_name == "dpcm4" else pcm4_encode_np
            stage, scales = enc4(stage)
        elif self.wire_dtype == np.int8:
            stage = mulaw_encode_np(stage)
        elif self.wire_dtype == np.int16:
            stage = np.round(np.clip(stage, -1.0, 1.0) * 32767.0).astype(np.int16)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])).to(self.device)  # noqa: E731
        n_valid = np.array([p[1] for p in prepared], np.int64)
        padded = put(stage)
        self.last_staging = {
            "batch": b_global,
            "sharding": (f"dp {dp}: rows [{rows.start}, {rows.stop})" if dp > 1
                         else "sequence-parallel" if use_sp else "whole"),
            "rows": (rows.start, rows.stop),
            "per_device_shape": tuple(padded.shape),
        }
        return _StagedBatch(padded=padded, scales=put(scales) if scales is not None else None,
                            n_valid=put(n_valid), bucket=bucket, b=padded.shape[0],
                            n_req=n_req, durations=durations, use_sp=use_sp, dp=dp,
                            rows=rows, b_global=b_global)

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
        with trace.span("asr.encode"):
            mel = self._wire_to_mel(st.padded, st.n_valid, st.bucket, st.scales)
            return encode(self.encoder_params, mel, st.n_valid, self.cfg.encoder,
                          mesh=self._mesh, sp_mesh=self._mesh if st.use_sp else None)

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
        vocab_mesh = tp_parts(self.decoder_params, dcfg, self._mesh)[2]
        emb_prefix = embedding_lookup(table, prompt.prefix_ids, dcfg.hidden_size, vocab_mesh)
        emb_suffix = embedding_lookup(table, prompt.suffix_ids, dcfg.hidden_size, vocab_mesh)
        embeds = torch.cat([emb_prefix, audio_tokens.to(emb_prefix.dtype), emb_suffix], dim=1)
        valid = torch.cat([
            torch.arange(pb, device=dev)[None] < prompt.prefix_len[:, None],
            torch.arange(a_pad, device=dev)[None] < n_audio[:, None],
            torch.arange(sb, device=dev)[None] < prompt.suffix_len[:, None],
        ], dim=1)
        cache = make_cache(dcfg, b, cache_len, kv_dtype, device=dev,
                           kv_heads=local_kv_heads(self.decoder_params, dcfg))
        hidden, cache = prefill(self.decoder_params, dcfg, embeds, valid, cache, self._mesh)
        last_idx = pb + a_pad + prompt.suffix_len - 1
        logits = tied_lm_head(hidden[torch.arange(b, device=dev), last_idx], table, vocab_mesh)
        return logits, cache, valid

    @torch.inference_mode()
    def _gen_start(self, audio_tokens, n_audio, prompt: _Prompt, max_new: int,
                   opts: SamplingOptions, generator: Optional[torch.Generator] = None,
                   noise_rows: Optional[tuple] = None) -> DecodeState:
        """Prefill a cache with room for ``max_new`` tokens, pick token 0.
        ``noise_rows``: see :class:`DecodeState`."""
        with trace.span("asr.prefill"):
            t_prompt = (prompt.prefix_ids.shape[1] + audio_tokens.shape[1]
                        + prompt.suffix_ids.shape[1])
            logits, cache, _ = self._prefill(audio_tokens, n_audio, prompt, t_prompt + max_new,
                                             self.kv_dtype)
            b, dev = logits.shape[0], self.device
            tokens = torch.full((b, max_new), self.cfg.pad_id, dtype=torch.int64, device=dev)
            logprobs = torch.zeros((b, max_new), dtype=torch.float32, device=dev)
            tok0 = sample_token(logits, opts, generator, tokens, 0, noise_rows=noise_rows)
            tokens[:, 0] = tok0
            logprobs[:, 0] = log_softmax_confidence(logits, tok0)
            return DecodeState(step=1, tokens=tokens, logprobs=logprobs, cache=cache,
                               done=tok0 == self.cfg.eos_id, last_tok=tok0, generator=generator,
                               noise_rows=noise_rows)

    @torch.inference_mode()
    def _gen_chunk(self, state: DecodeState, end: int, opts: SamplingOptions) -> DecodeState:
        """Decode steps ``state.step .. end-1`` with no host sync: op by op,
        or, where :func:`uses_step_graph` says so, by replays of the step
        captured once (:meth:`_capture`)."""
        with trace.span("asr.decode_chunk"):
            for step in range(state.step, end):
                with trace.span("asr.step"):
                    if state.graph is None and uses_step_graph(
                            self.device, self._mesh, opts, step, state.tokens.shape[1]):
                        with trace.span("asr.capture"):
                            state.graph = self._capture(state, opts, step)
                    if state.graph is not None:
                        state.graph.replay(state)
                    else:
                        self._eager_step(state, opts, step)
            # the chunk's last kernel, launched op by op: a profiler's device
            # range of the chunk then ends after the last replay's kernels
            state.all_done = state.done.all()
        state.step = max(state.step, end)
        return state

    def _eager_step(self, state: DecodeState, opts: SamplingOptions, step: int) -> None:
        """Decode step ``step``, each kernel launched from the host."""
        pad, eos = self.cfg.pad_id, self.cfg.eos_id
        with trace.span("asr.decoder"):
            logits, _ = decode_step(self.decoder_params, self.cfg.decoder,
                                    state.last_tok, state.cache, self._mesh)
        with trace.span("asr.sample"):
            tok = sample_token(logits, opts, state.generator, state.tokens, step,
                               noise_rows=state.noise_rows)
            tok = force_eos_after(tok, step, opts, eos)
            lp = log_softmax_confidence(logits, tok)
            tok = torch.where(state.done, torch.full_like(tok, pad), tok)
            state.tokens[:, step] = tok  # rows already done write their pad
            state.logprobs[:, step] = torch.where(state.done, torch.zeros_like(lp), lp)
            state.done = state.done | (tok == eos)
            state.last_tok = tok
        trace.EAGER_STEPS.add()

    def _device_step(self, state: DecodeState, opts: SamplingOptions, g: StepGraph) -> None:
        """The greedy step that :meth:`_capture` records: :meth:`_eager_step`'s
        work on the same operands, with the step index and the cache row read
        from ``g`` and advanced there, and every write of ``state`` in place,
        so that each replay decodes the next step. ``state.cache.cursor`` is
        the caller's to advance."""
        pad, eos = self.cfg.pad_id, self.cfg.eos_id
        logits, _ = decode_step(self.decoder_params, self.cfg.decoder, state.last_tok,
                                state.cache, self._mesh, cursor=g.cursor)
        tok = sample_token(logits, opts)
        if opts.force_eos_after:
            tok = torch.where(g.step >= opts.force_eos_after, torch.full_like(tok, eos), tok)
        lp = log_softmax_confidence(logits, tok)
        tok = torch.where(state.done, torch.full_like(tok, pad), tok)
        state.tokens.index_copy_(1, g.step, tok[:, None])
        state.logprobs.index_copy_(1, g.step, torch.where(state.done, torch.zeros_like(lp),
                                                          lp)[:, None])
        state.done |= tok == eos
        state.last_tok.copy_(tok)
        g.step += 1

    def _capture(self, state: DecodeState, opts: SamplingOptions, step: int) -> StepGraph:
        """Capture step ``step`` of ``state`` (:meth:`_device_step`) as a CUDA
        graph. Nothing runs: the caller replays it for this step and the
        rest. The capture's launches are held and added at each replay. It
        runs on a side stream of the device, one capture at a time in the
        process, and shares the memory pool of the last graph this thread
        captured, which is dropped then (each thread's graphs run one after
        another; a new pool each batch would stay reserved once freed)."""
        g = StepGraph.at(state, step)
        graph = torch.cuda.CUDAGraph()
        last = getattr(self._graphs, "last", None)
        with _CAPTURE_LOCK:
            stream = _capture_streams.get(self.device)
            if stream is None:
                stream = _capture_streams[self.device] = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream), trace.held_launches() as held:
                graph.capture_begin(pool=None if last is None else last.pool(),
                                    capture_error_mode="thread_local")
                try:
                    self._device_step(state, opts, g)
                finally:
                    graph.capture_end()
        self._graphs.last = graph
        g.graph, g.launches = graph, held
        trace.GRAPH_CAPTURES.add()
        return g

    @staticmethod
    def _all_done(state: DecodeState) -> bool:
        with trace.span("asr.done_read"):
            return bool(state.all_done.item())  # host sync: chunk boundaries only

    def _generate(self, st: _StagedBatch, prompt_args, opts: SamplingOptions, priority,
                  generator: torch.Generator, timings=None):
        """Encode + prefill + chunked decode (or beam search), under the
        dispatch gate if any. Returns (tokens [B, max_new], logprobs)."""
        gate = self.dispatch_gate
        max_new = opts.max_tokens
        chunk = self.decode_chunk_tokens or max_new
        fused = (gate is not None and st.n_req == 1 and timings is None and opts.beam <= 1
                 and self._mesh is None)
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

        noise_rows = (st.rows.start, st.n_req) if st.dp > 1 else None

        def start(audio):
            return self._gen_start(*audio, self._prompt(st.b, *prompt_args), max_new, opts,
                                   generator, noise_rows)

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
        self.last_loop = {"decode_steps": state.step - 1}
        return state.tokens, state.logprobs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            with _CAPTURE_LOCK:   # not while another thread captures
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # public inference
    # ------------------------------------------------------------------ #

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16000,
                   language: Optional[str] = None, context: Optional[str] = None,
                   max_tokens: Optional[int] = None, options: Optional[SamplingOptions] = None,
                   priority: Optional[int] = None, timings: Optional[dict] = None,
                   **kwargs) -> TranscriptionResult:
        return self.transcribe_batch(
            [audio], sample_rate=sample_rate, language=language, context=context,
            max_tokens=max_tokens, options=options, priority=priority, timings=timings)[0]

    def transcribe_batch(self, audios: Optional[Sequence[np.ndarray]] = None,
                         sample_rate: int = 16000, language: Optional[str] = None,
                         context: Optional[str] = None, max_tokens: Optional[int] = None,
                         options: Optional[SamplingOptions] = None, seed: int = 0,
                         timings: Optional[dict] = None, priority: Optional[int] = None,
                         prestaged: Optional[_StagedBatch] = None) -> List[TranscriptionResult]:
        """Transcribe a batch: one audio bucket (the largest needed), one
        prompt shape. ``seed`` seeds the ``torch.Generator`` that
        temperature sampling draws from. ``timings`` receives per-stage wall
        times ({host_prep, encode, generate, postprocess} s) with a device
        sync at each boundary. ``prestaged`` is a :meth:`prestage` handle."""
        with trace.span("asr.batch"):
            t_start = time.perf_counter()
            opts = options or SamplingOptions(
                max_tokens=self.max_tokens if max_tokens is None else max_tokens)
            check_supported(opts)
            if opts.beam > 1 and self._mesh is not None and self._mesh.dp > 1:
                raise ValueError("beam decode runs single-chip or TP-sharded; "
                                 "dp/multi-process meshes batch greedy decodes "
                                 "instead (the beam dim folds into batch)")
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
            with trace.span("asr.fetch"):
                if st.dp > 1:   # every rank returns every row
                    tokens = self._mesh.dp_gather(tokens)
                    logprobs = self._mesh.dp_gather(logprobs)
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
        with trace.span("asr.finalize"):
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

    # ------------------------------------------------------------------ #

    def shard(self, mesh=None, dp: Optional[int] = None, tp: Optional[int] = None) -> "Qwen3ASR":
        """Spread the model over a (dp, tp) mesh of ranks (encoder and
        decoder partition rules; packed params shard too). Every rank calls
        this with the same arguments on the same weights; each keeps its
        shard. Returns self.

            model = Qwen3ASR.init_random(cfg, device=f"cuda:{rank}").shard(tp=2)
        """
        from ...parallel import QWEN3_ENCODER_RULES, make_mesh, shard_pytree

        if self.quant_compute == "groupdot":
            raise ValueError(
                "quant_compute='groupdot' is single-chip (the repacked int8 "
                "layout has no TP partition rules); use 'packed' or "
                "'dequant' for sharded execution")
        mesh = mesh or make_mesh(dp=dp, tp=tp, device=self.device)
        ecfg, dcfg = self.cfg.encoder, self.cfg.decoder
        layer = r"(.*layers/\d+/)"
        self.encoder_params = shard_pytree(
            self.encoder_params, mesh, QWEN3_ENCODER_RULES,
            heads=((r".*(q_proj|k_proj|v_proj|out_proj)/", ecfg.num_heads),),
            ties=(layer + r"(q_proj|k_proj|v_proj|out_proj)/", layer + r"(fc1|fc2)/",
                  r"(.*)(proj1|proj2)/"))
        self.decoder_params = shard_decoder(self.decoder_params, dcfg, mesh)
        self._mesh = mesh
        return self

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
