"""Qwen3-TTS on one device — port of
``qwen3_asr_swift_tpu/models/qwen3_tts/model.py``.

- prompt: chat-template text tokens and the codec prefix ``[think,
  think_bos, lang, think_eos, (speaker), pad, bos]`` with the reference's
  element-wise text/codec overlay (:meth:`Qwen3TTS._build_prompt_fused`,
  and :meth:`Qwen3TTS._build_prompt_embeds` for voice clones and
  instructions);
- the frame loop (:meth:`Qwen3TTS._generate`): talker step → sample
  codebook 0 (2048..3071 suppressed except EOS, the repetition penalty over
  a ring of recent codes, top-k, Gumbel noise when temperature > 0) → the
  code predictor completes codebooks 1..15 → the next talker input is the
  trailing text (or tts_pad) embedding plus the 16 codec embeddings. A
  frame reads nothing back to the host; ``done`` is read every
  :data:`DONE_CHECK_FRAMES` frames, and rows that are done record nothing,
  so the codes and ``n_frames`` do not depend on how often it is read;
- the codec decode of the frames (``codec.py``).

``quant_bits`` packs the talker's and the code predictor's linears (MLX
group 64) on the device; packed trees (from ``quant_bits`` or a packed
checkpoint) fuse q/k/v and gate/up. ``quant_compute="fused"`` keeps them
packed, and their decode-shaped products run kernel K1; ``"groupdot"``, the
reference's default, repacks them to int8 codes for
``quant_matmul_groupdot``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ...core.logging import inference as log
from ...core.params import params_from_jax
from ...core.protocols import SpeechGenerationModel
from ...core.types import AudioChunk
from ...device import resolve_device
from ...ops.attention import NEG_INF
from ...ops.nn import fuse_qkv_gate_up
from ...ops.quant import cast_tree, quantize_tree, repack_tree_groupdot
from ...ops.sampling import SamplingOptions, sample_token
from ...tokenizers.bpe import BPETokenizer
from .codec import CodecDecoder, init_codec_params
from .code_predictor import embed_all_groups, init_cp_params, predict_codebooks
from .config import CONFIG_06B, CodecTokens, Qwen3TTSConfig
from .talker import (embed_codec, embed_text, init_talker_params, make_talker_cache,
                     talker_prefill, talker_step)
from .voice_clone import ReferenceAudioCache

#: ``done`` is read on the host every this many frames (the frame loop
#: otherwise never syncs); what a frame records does not depend on it
DONE_CHECK_FRAMES = 8
#: the group size of packed trees: ``quant_bits``'s and the published
#: checkpoints'
GROUP_SIZE = 64


@dataclasses.dataclass(frozen=True)
class TTSSamplingConfig:
    """reference: Sources/Qwen3TTS/Sampling.swift:6-29."""

    temperature: float = 0.9
    top_k: int = 50
    repetition_penalty: float = 1.05
    max_frames: int = 500  # reference caps at 500 (Qwen3TTS.swift:1407)
    rep_window: int = 64


def _round_up(n: int, q: int) -> int:
    return max(q, ((n + q - 1) // q) * q)


def sample_code0(logits: torch.Tensor, ring: torch.Tensor, sampling: TTSSamplingConfig,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Codebook 0 of a frame: logits [B, V] → int64 [B]. The special range
    2048..3071 is suppressed except EOS; codes in the ring [B, W] (-1 =
    empty) take the repetition penalty; then top-k and, when temperature >
    0, Gumbel noise from ``generator``."""
    lg = logits.float()
    ids = torch.arange(lg.shape[-1], device=lg.device)
    special = (ids >= 2048) & (ids < 3072) & (ids != CodecTokens.EOS)
    lg = torch.where(special[None], torch.full_like(lg, NEG_INF), lg)
    if sampling.repetition_penalty != 1.0:
        hits = torch.zeros(lg.shape, dtype=torch.int32, device=lg.device)
        hits.scatter_add_(1, ring.clamp(min=0), (ring >= 0).to(torch.int32))
        pen = sampling.repetition_penalty
        lg = torch.where(hits > 0, torch.where(lg > 0, lg / pen, lg * pen), lg)
    return sample_token(lg, SamplingOptions(temperature=sampling.temperature,
                                            top_k=sampling.top_k), generator)


def _is_quantized(tree) -> bool:
    if isinstance(tree, dict):
        return "codes" in tree or any(_is_quantized(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_is_quantized(v) for v in tree)
    return False


class Qwen3TTS(SpeechGenerationModel):
    """Qwen3-TTS (0.6B / 1.7B) on one device.

    ``talker_params``, ``cp_params`` and ``codec_params`` are trees in the
    JAX package's layout (numpy arrays or tensors), carried onto ``device``
    by ``core.params.params_from_jax``. ``quant_bits`` packs dense talker
    and code-predictor linears at load."""

    def __init__(self, cfg: Qwen3TTSConfig, talker_params, cp_params, codec_params, *,
                 device="cuda", tokenizer: Optional[BPETokenizer] = None,
                 dtype: torch.dtype = torch.bfloat16, speakers: Optional[dict] = None,
                 encoder_params=None, speaker_encoder_params=None,
                 quant_bits: Optional[int] = None, quant_compute: str = "groupdot"):
        if quant_compute not in ("groupdot", "fused"):
            raise ValueError(f"unknown quant_compute {quant_compute!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.tokenizer = tokenizer
        self.speakers = speakers or {}
        self.quant_compute = quant_compute
        #: the sampling of a call that passes none, as the server's batchers
        #: and the slot pool do
        self.sampling = TTSSamplingConfig()
        tp = params_from_jax(talker_params, self.device, torch.float32)
        cpp = params_from_jax(cp_params, self.device, torch.float32)
        del talker_params, cp_params
        if quant_bits:
            tp = quantize_tree(tp, quant_bits, GROUP_SIZE, embed_keys=())
            cpp = quantize_tree(cpp, quant_bits, GROUP_SIZE, embed_keys=())
        if _is_quantized(tp):
            # fewer, wider products: q/k/v and gate/up fuse (exact row concat)
            tp, cpp = fuse_qkv_gate_up(tp), fuse_qkv_gate_up(cpp)
        if quant_compute == "groupdot":
            tp = repack_tree_groupdot(tp, GROUP_SIZE)
            cpp = repack_tree_groupdot(cpp, GROUP_SIZE)
        self.talker_params = cast_tree(tp, dtype)
        self.cp_params = cast_tree(cpp, dtype)
        del tp, cpp
        self.codec = CodecDecoder(codec_params, cfg.codec, torch.float32, device=self.device)
        self.encoder_params = (params_from_jax(encoder_params, self.device, torch.float32)
                               if encoder_params is not None else None)
        self.speaker_encoder_params = (
            params_from_jax(speaker_encoder_params, self.device, torch.float32)
            if speaker_encoder_params is not None else None)
        self.ref_cache = ReferenceAudioCache()
        #: frames the last frame loop ran (the first frame included), and
        #: the host reads of ``done`` it made
        self.last_loop = {"frames_run": 0, "done_reads": 0}
        self._loaded = True

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def init_random(cls, cfg: Optional[Qwen3TTSConfig] = None, seed: int = 0, *,
                    device="cuda", dtype: torch.dtype = torch.bfloat16, tokenizer=None,
                    **kw) -> "Qwen3TTS":
        """Random weights drawn with numpy from ``seed`` (talker, code
        predictor, codec decoder, codec encoder and speaker encoder)."""
        from .voice_clone import init_codec_encoder, init_speaker_encoder

        cfg = cfg or CONFIG_06B
        rng = np.random.default_rng(seed)
        talker = init_talker_params(rng, cfg.talker)
        cp = init_cp_params(rng, cfg.code_predictor)
        codec = init_codec_params(rng, cfg.codec)
        return cls(cfg, talker, cp, codec, device=device, tokenizer=tokenizer, dtype=dtype,
                   encoder_params=init_codec_encoder(rng, cfg.codec),
                   speaker_encoder_params=init_speaker_encoder(rng), **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "aufklarer/Qwen3-TTS-1.7B-MLX-4bit",
                        cache_dir=None, offline_mode: bool = False, progress_handler=None, *,
                        dtype: torch.dtype = torch.bfloat16, **kw) -> "Qwen3TTS":
        """Load a checkpoint in the published layout from a local directory
        (``*.safetensors``, the tokenizer files, and ``config.json`` for
        named speakers). The directory's name picks the size and the bits,
        as a model id does. A model id is found in the cache or fetched
        (``core/hub.py``)."""
        from ...core.config import detect_bits
        from ...core.hub import download_weights
        from ...core.weights import load_safetensors
        from .convert import convert_tts_checkpoint, detect_tts_config, load_speaker_config

        model_dir = download_weights(
            model_id, cache_dir=cache_dir, offline_mode=offline_mode,
            additional_files=("vocab.json", "merges.txt", "tokenizer_config.json", "config.json"),
        )
        cfg = detect_tts_config(model_id, model_dir)
        tokenizer = BPETokenizer.from_pretrained_dir(model_dir)
        flat = load_safetensors(model_dir)
        talker, cp, codec = convert_tts_checkpoint(flat, cfg, bits=detect_bits(model_id) or 4)
        return cls(cfg, talker, cp, codec, tokenizer=tokenizer, dtype=dtype,
                   speakers=load_speaker_config(model_dir), **kw)

    # ------------------------------------------------------------------ #
    # prompts
    # ------------------------------------------------------------------ #

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.int64, device=self.device)

    def _check_vocab(self, ids, what: str = "text") -> None:
        oov = max(ids)
        if oov >= self.cfg.talker.text_vocab_size:
            raise ValueError(f"{what} token id {oov} >= text_vocab_size "
                             f"{self.cfg.talker.text_vocab_size}; tokenizer does not "
                             f"match this checkpoint's text vocabulary")

    def _special_text(self):
        """(tts_pad, tts_bos, tts_eos) text embeddings, each [H]."""
        tk = self.cfg.talker
        sp = embed_text(self.talker_params, self._ids([[tk.tts_pad_id, tk.tts_bos_id,
                                                        tk.tts_eos_id]]), tk)
        return sp[0, 0], sp[0, 1], sp[0, 2]

    @torch.inference_mode()
    def _build_prompt_embeds(self, text: str, language: str, speaker: Optional[str],
                             instruct: Optional[str], clone=None):
        """The reference's eager prompt: (prefill [1, P, H], trailing
        [1, L, H], tts_pad [H]). ``clone`` = (ref_codes [T, 16], ref_text)
        splices a voice clone's codec frames after BOS, its transcript before
        the text."""
        if self.tokenizer is None:
            raise RuntimeError("synthesis requires a tokenizer")
        tk = self.cfg.talker
        if clone is not None:
            text = f"{clone[1]} {text}" if clone[1] else text
        text_tokens = [tk.im_start_id, tk.assistant_id, tk.nl_id] + self.tokenizer.encode(text) + \
                      [tk.im_end_id, tk.nl_id, tk.im_start_id, tk.assistant_id, tk.nl_id]
        self._check_vocab(text_tokens)
        codec_prefix = self._codec_prefix_ids(language, None if clone else speaker)
        tp = self.talker_params
        text_embeds = embed_text(tp, self._ids(text_tokens)[None], tk)      # [1, L, H]
        codec_embeds = embed_codec(tp, self._ids(codec_prefix)[None])
        tts_pad, tts_bos, tts_eos = self._special_text()
        n_codec = len(codec_prefix)
        overlay = torch.cat([tts_pad[None].expand(n_codec - 2, -1), tts_bos[None]], dim=0)
        combined = overlay[None] + codec_embeds[:, :n_codec - 1]
        pieces = [text_embeds[:, :3], combined]
        if clone is not None:
            codes = self._ids(np.asarray(clone[0]))                          # [T, 16]
            frame = embed_codec(tp, codes[None, :, 0]) + embed_all_groups(
                self.cp_params, self.cfg.code_predictor, codes[:, 1:])[None]
            pieces.append((frame + tts_pad[None, None]).to(text_embeds.dtype))
        pieces.append(text_embeds[:, 3:4] + codec_embeds[:, -1:])
        if instruct:
            instruct_ids = [tk.im_start_id, tk.user_id, tk.nl_id] + \
                self.tokenizer.encode(instruct) + [tk.im_end_id, tk.nl_id]
            self._check_vocab(instruct_ids, "instruct")
            pieces.insert(0, embed_text(tp, self._ids(instruct_ids)[None], tk))
        prefill = torch.cat(pieces, dim=1)
        trailing = torch.cat([text_embeds[:, 4:-5], tts_eos[None, None]], dim=1)
        return prefill, trailing, tts_pad

    def _codec_prefix_ids(self, language: str, speaker: Optional[str]) -> List[int]:
        lang_id = CodecTokens.language_id(language) or CodecTokens.LANGUAGES["en"]
        spk_id = self.speakers.get((speaker or "").lower())
        prefix = [CodecTokens.THINK, CodecTokens.THINK_BOS, lang_id, CodecTokens.THINK_EOS]
        if spk_id is not None:
            prefix.append(spk_id)
        prefix += [CodecTokens.PAD, CodecTokens.BOS]
        return prefix

    @torch.inference_mode()
    def _build_prompt_fused(self, text: str, language: str, speaker: Optional[str]):
        """The reference's one-program prompt (no clone, no instruction):
        (prefill [1, p_block, H], trailing [1, t_block, H], tts_pad [H],
        p_len, t_len, p_block, t_block), padded and cast. The text rows go
        through the text projection as one ``[1, text_block]`` batch."""
        tk = self.cfg.talker
        enc = self.tokenizer.encode(text)
        # the trailing IM_END keeps the eager path's empty-text behaviour:
        # with no text, first_text falls on the chat suffix's first token
        text_tokens = [tk.im_start_id, tk.assistant_id, tk.nl_id] + enc + [tk.im_end_id]
        self._check_vocab(text_tokens)
        codec_prefix = self._codec_prefix_ids(language, speaker)
        n_codec = len(codec_prefix)
        n_text = len(text_tokens) - 1
        p_len, t_len = n_codec + 3, max(n_text - 3, 1)
        p_block, t_block = _round_up(p_len, 32), _round_up(t_len, 32)
        ids = np.zeros((1, _round_up(n_text + 1, 32)), np.int64)
        ids[0, :n_text + 1] = text_tokens

        tp = self.talker_params
        emb = embed_text(tp, self._ids(ids), tk)                            # [1, TB, H]
        codec_embeds = embed_codec(tp, self._ids([codec_prefix]))
        tts_pad, tts_bos, tts_eos = self._special_text()
        overlay = torch.cat([tts_pad[None].expand(n_codec - 2, -1), tts_bos[None]], dim=0)
        combined = overlay[None] + codec_embeds[:, :n_codec - 1]
        prefill = torch.cat([emb[:, :3], combined, emb[:, 3:4] + codec_embeds[:, -1:]], dim=1)
        prefill = torch.nn.functional.pad(prefill, (0, 0, 0, p_block - prefill.shape[1]))
        # trailing = encode(text)[1:] then tts_eos at row max(n_text - 4, 0)
        take = min(t_block, emb.shape[1] - 4)
        trailing = torch.nn.functional.pad(emb[:, 4:4 + take], (0, 0, 0, t_block - take)).clone()
        trailing[0, max(n_text - 4, 0)] = tts_eos
        return (prefill.to(self.dtype), trailing.to(self.dtype), tts_pad.to(self.dtype),
                p_len, t_len, p_block, t_block)

    # ------------------------------------------------------------------ #
    # the frame loop
    # ------------------------------------------------------------------ #

    def _first_frame(self, logits0, hidden0, ring, sampling, generator):
        """code0 and the code predictor's chain for one frame: int64 [B, 16]."""
        tp, cpp = self.talker_params, self.cp_params
        code0 = sample_code0(logits0, ring, sampling, generator)
        cp = predict_codebooks(cpp, self.cfg.code_predictor, hidden0.to(self.dtype),
                               embed_codec(tp, code0).to(self.dtype), generator,
                               temperature=sampling.temperature, top_k=sampling.top_k)
        return torch.cat([code0[:, None], cp], dim=1)

    @torch.inference_mode()
    def _generate(self, prefill_embeds, prefill_len, trailing, trail_len, tts_pad_embed,
                  generator: torch.Generator, *, p_block: int, t_block: int,
                  max_frames: int, sampling: TTSSamplingConfig):
        """The talker + code-predictor loop over B rows. prefill_embeds
        [B, p_block, H], prefill_len [B], trailing [B, t_block, H], trail_len
        [B], tts_pad_embed [1, H]. Returns (codes int64 [B, max_frames, 16],
        n_frames [B]) on the device; a row's frames after its EOS stay 0."""
        tcfg, cpcfg = self.cfg.talker, self.cfg.code_predictor
        tp, cpp = self.talker_params, self.cp_params
        dev, b = self.device, prefill_embeds.shape[0]
        rows = torch.arange(b, device=dev)
        cache = make_talker_cache(tcfg, b, p_block + max_frames, self.dtype, device=dev)
        valid = torch.arange(p_block, device=dev)[None] < prefill_len[:, None]
        logits, hidden, cache = talker_prefill(tp, tcfg, prefill_embeds, valid, cache)
        last = prefill_len - 1
        codes_out = torch.zeros((b, max_frames, 16), dtype=torch.int64, device=dev)
        ring = torch.full((b, sampling.rep_window), -1, dtype=torch.int64, device=dev)

        frame = self._first_frame(logits[rows, last], hidden[rows, last], ring, sampling,
                                  generator)
        done = frame[:, 0] == CodecTokens.EOS
        codes_out[:, 0] = torch.where(done[:, None], 0, frame)
        ring[:, 0] = torch.where(done, -1, frame[:, 0])
        n_frames = (~done).to(torch.int64)
        reads = 0
        step = 1
        while step < max_frames:
            if (step - 1) % DONE_CHECK_FRAMES == 0:
                reads += 1
                if bool(done.all()):
                    break
            text_emb = torch.where((step - 1 < trail_len)[:, None],
                                   trailing[:, min(step - 1, t_block - 1)], tts_pad_embed)
            codec_emb = embed_codec(tp, frame[:, 0]) + embed_all_groups(cpp, cpcfg, frame[:, 1:])
            x = (text_emb + codec_emb)[:, None].to(self.dtype)
            logits, hidden, cache = talker_step(tp, tcfg, x, cache)
            frame = self._first_frame(logits, hidden, ring, sampling, generator)
            newly_done = frame[:, 0] == CodecTokens.EOS
            record = ~done & ~newly_done
            codes_out[:, step] = torch.where(record[:, None], frame, codes_out[:, step])
            slot = step % sampling.rep_window
            ring[:, slot] = torch.where(record, frame[:, 0], ring[:, slot])
            done = done | newly_done
            n_frames += record
            step += 1
        self.last_loop = {"frames_run": step, "done_reads": reads}
        return codes_out, n_frames

    def _generate_device(self, text: str, language: str = "english",
                         speaker: Optional[str] = None, instruct: Optional[str] = None,
                         sampling: Optional[TTSSamplingConfig] = None, seed: int = 0):
        """The frame loop of one text: device codes [1, max_frames, 16] and
        n_frames [1]. ``speaker`` names a built-in speaker or a registered
        voice clone."""
        sampling = sampling or self.sampling
        clone = self.ref_cache.get(speaker) if speaker else None
        if clone is None and instruct is None and self.tokenizer is not None:
            prefill, trailing, tts_pad, p_len, t_len, p_block, t_block = \
                self._build_prompt_fused(text, language, speaker)
        else:
            prefill, trailing, tts_pad = self._build_prompt_embeds(
                text, language, speaker, instruct, clone=clone)
            p_len, t_len = prefill.shape[1], trailing.shape[1]
            p_block, t_block = _round_up(p_len, 32), _round_up(t_len, 32)
            pad = torch.nn.functional.pad
            prefill = pad(prefill, (0, 0, 0, p_block - p_len)).to(self.dtype)
            trailing = pad(trailing, (0, 0, 0, t_block - t_len)).to(self.dtype)
            tts_pad = tts_pad.to(self.dtype)
        return self._generate(
            prefill, self._ids([p_len]), trailing, self._ids([t_len]), tts_pad[None],
            torch.Generator(device=self.device).manual_seed(seed),
            p_block=p_block, t_block=t_block, max_frames=min(sampling.max_frames, 500),
            sampling=sampling)

    # ------------------------------------------------------------------ #
    # public inference
    # ------------------------------------------------------------------ #

    def generate_codes(self, text: str, language: str = "english", speaker: Optional[str] = None,
                       instruct: Optional[str] = None,
                       sampling: Optional[TTSSamplingConfig] = None, seed: int = 0):
        """(codes int [16, n_frames] on the host, n_frames)."""
        codes, n_frames = self._generate_device(text, language, speaker, instruct, sampling, seed)
        n = int(n_frames[0])
        return codes[0, :n].T.cpu().numpy(), n

    def synthesize(self, text: str, voice: Optional[str] = None, language: str = "english",
                   instruct: Optional[str] = None, sampling: Optional[TTSSamplingConfig] = None,
                   seed: int = 0, max_frames: Optional[int] = None, **kwargs) -> AudioChunk:
        if max_frames is not None:
            sampling = dataclasses.replace(sampling or self.sampling, max_frames=max_frames)
        t0 = time.perf_counter()
        codes, n_frames = self._generate_device(text, language, voice, instruct, sampling, seed)
        n = int(n_frames[0])   # the one host read before the codec
        sr = self.cfg.codec.sample_rate
        if n == 0:
            return AudioChunk(np.zeros(0, np.float32), sr)
        wav = self.codec.decode_frames(codes, n)[0]
        dt = time.perf_counter() - t0
        dur = len(wav) / sr
        log.info("tts: %d frames, %.2fs audio, RTF %.3f", n, dur, dt / max(dur, 1e-6))
        return AudioChunk(np.asarray(wav, np.float32), sr)

    def synthesize_stream(self, text: str, voice: Optional[str] = None, language: str = "english",
                          max_frames: Optional[int] = None, instruct: Optional[str] = None,
                          sampling: Optional[TTSSamplingConfig] = None,
                          seed: int = 0) -> Iterator[AudioChunk]:
        """The codes of :meth:`synthesize`, decoded in chunks."""
        if sampling is None and max_frames is not None:
            sampling = dataclasses.replace(self.sampling, max_frames=max_frames)
        codes, n = self.generate_codes(text, language, voice, instruct, sampling=sampling,
                                       seed=seed)
        if n == 0:
            return
        for chunk in self.codec.decode_stream(codes):
            yield AudioChunk(np.asarray(chunk, np.float32), self.cfg.codec.sample_rate)

    def synthesize_batch(self, texts: Sequence[str], language: str = "english",
                         voice: Optional[str] = None, instruct: Optional[str] = None,
                         sampling: Optional[TTSSamplingConfig] = None,
                         seed: int = 0, **kwargs) -> List[AudioChunk]:
        """Batched synthesis: the prompts pad to shared blocks and run one
        frame loop with B rows; each row's EOS masks it out. The codec
        decodes all rows at one shared frame bucket."""
        if not texts:
            return []
        sampling = sampling or self.sampling
        clone = self.ref_cache.get(voice) if voice else None
        built = [self._build_prompt_embeds(t, language, voice, instruct, clone=clone)
                 for t in texts]
        b = len(built)
        p_lens = [p.shape[1] for p, _, _ in built]
        t_lens = [tr.shape[1] for _, tr, _ in built]
        p_block, t_block = _round_up(max(p_lens), 32), _round_up(max(t_lens), 32)
        pad = torch.nn.functional.pad
        prefill = torch.cat([pad(p, (0, 0, 0, p_block - p.shape[1])) for p, _, _ in built]
                            ).to(self.dtype)
        trailing = torch.cat([pad(tr, (0, 0, 0, t_block - tr.shape[1])) for _, tr, _ in built]
                             ).to(self.dtype)
        codes, n_frames = self._generate(
            prefill, self._ids(p_lens), trailing, self._ids(t_lens),
            built[0][2].to(self.dtype)[None], torch.Generator(device=self.device).manual_seed(seed),
            p_block=p_block, t_block=t_block, max_frames=min(sampling.max_frames, 500),
            sampling=sampling)
        ns = n_frames.cpu().numpy()
        sr = self.cfg.codec.sample_rate
        n_max = int(ns.max())
        if n_max == 0:
            return [AudioChunk(np.zeros(0, np.float32), sr) for _ in range(b)]
        wavs = self.codec.decode_frames(codes, n_max)
        spf = self.cfg.codec.samples_per_frame
        return [AudioChunk(np.asarray(wavs[i, :int(ns[i]) * spf], np.float32), sr)
                for i in range(b)]

    # -- voice cloning ---------------------------------------------------

    @torch.inference_mode()
    def register_voice_clone(self, name: str, audio: np.ndarray, transcript: str = "",
                             sample_rate: int = 24000, max_frames: int = 50) -> None:
        """Encode reference audio to codec frames and cache them; synthesize
        with ``voice=name`` to clone (its frames and transcript join the
        prefill)."""
        from ...audio.resample import resample
        from .voice_clone import codec_encode

        if self.encoder_params is None:
            raise RuntimeError("no speech-tokenizer encoder loaded")
        sr = self.cfg.codec.sample_rate
        if sample_rate != sr:
            audio = resample(np.asarray(audio, np.float32), sample_rate, sr)
        wave = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)
        codes = codec_encode(self.encoder_params, self.codec.params, self.cfg.codec, wave)
        self.ref_cache.put(name, codes.cpu().numpy()[:max_frames], transcript)

    @torch.inference_mode()
    def speaker_embedding(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        """Unit-norm x-vector of a clip (for speaker similarity)."""
        from ...audio.resample import resample
        from .voice_clone import speaker_embed

        if self.speaker_encoder_params is None:
            raise RuntimeError("no speaker encoder loaded")
        if sample_rate != 16000:
            audio = resample(np.asarray(audio, np.float32), sample_rate, 16000)
        wave = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)
        return speaker_embed(self.speaker_encoder_params, wave).cpu().numpy()

    def warm_up(self, max_frames: Optional[int] = None) -> None:
        if self.tokenizer is not None:
            mf = max_frames or TTSSamplingConfig().max_frames
            self.synthesize("hi", sampling=TTSSamplingConfig(max_frames=mf))

    def unload(self) -> None:
        self.talker_params = None
        self.cp_params = None
        self.codec = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded
