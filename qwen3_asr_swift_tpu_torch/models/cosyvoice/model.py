"""CosyVoice3 TTS on one device: Qwen2.5 LLM → flow-matching DiT → HiFT
vocoder — port of ``qwen3_asr_swift_tpu/models/cosyvoice/model.py``.

1. The Qwen2.5-0.5B LM emits FSQ speech tokens (vocab 6561 + 200 control
   rows; sos/eos/task_id/fill at 6561..6564) from the prompt ``[sos,
   text…, task_id, (prompt speech tokens…)]`` with top-k 25 / top-p 0.8
   nucleus sampling, repetition-aware resampling and the min/max
   token-to-text ratios (:func:`llm_generate_tokens`): a bucketed prefix
   prefill into a float cache, then a token loop of device ops that reads
   ``done`` on the host every :data:`DONE_CHECK_TOKENS` tokens; tokens
   after the stop record nothing, so the result does not depend on that
   cadence.
2. The 22-layer AdaLN-Zero DiT integrates a CFG Euler ODE (10 steps) from
   noise to 80-mel at 50 Hz (``dit.py``).
3. The HiFT neural-source-filter vocoder renders 24 kHz audio (``hift.py``).

The reference draws its noise with ``jax.random``; here every function
with a draw takes it as a tensor (the LLM's two Gumbel draws a step, the
flow's start, the source's phase and noises), and the public methods draw
those from a ``torch.Generator`` on the model's device seeded with
``seed``, ``seed + 1`` and ``seed + 2`` for the three stages, as the
reference keys them. So one seed gives one output.

Voice cloning: a CAM++ 192-d x-vector conditions the flow, and optional
reference FSQ codes + mel anchor the LM prompt and the DiT ``cond`` slot.
:meth:`clone_voice` embeds with the caller's speaker model, or with the
port's CAM++ (``models/speaker/campplus.py``) loaded by ``from_pretrained``
as the reference loads it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import SpeechGenerationModel
from ...core.types import AudioChunk
from ...device import resolve_device
from ...ops.attention import NEG_INF
from ...ops.nn import acc_dtype, linear, rms_norm
from ...ops.qwen2 import qwen2_decoder_layer
from .dit import CosyFlowConfig, draw_flow_params, flow_config_tiny, flow_generate
from .hift import CosyHiFTConfig, draw_hift_params, hift_config_tiny, hift_generate, source_noise

#: ``done`` is read on the host every this many tokens (the token loop
#: otherwise never syncs); what a token records does not depend on it
DONE_CHECK_TOKENS = 16


@dataclasses.dataclass(frozen=True)
class CosyVoiceConfig:
    # LLM (Qwen2.5-0.5B — reference: Configuration.swift:5-41)
    hidden_size: int = 896
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 4864
    text_vocab: int = 151936
    speech_token_size: int = 6561     # FSQ codes
    speech_token_extra: int = 200     # control rows appended to the codes
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    # sampling (reference: CosyVoiceSamplingConfig)
    top_k: int = 25
    top_p: float = 0.8
    ras_win_size: int = 10
    ras_tau_r: float = 0.1
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0
    max_tokens: int = 500
    # stages
    flow: CosyFlowConfig = dataclasses.field(default_factory=CosyFlowConfig)
    hift: CosyHiFTConfig = dataclasses.field(default_factory=CosyHiFTConfig)
    sample_rate: int = 24000

    @property
    def speech_vocab(self) -> int:
        return self.speech_token_size + self.speech_token_extra

    @property
    def sos_token(self) -> int:
        return self.speech_token_size

    @property
    def eos_token(self) -> int:
        return self.speech_token_size + 1

    @property
    def task_id_token(self) -> int:
        return self.speech_token_size + 2

    @property
    def fill_token(self) -> int:
        return self.speech_token_size + 3

    @property
    def stop_tokens(self) -> Tuple[int, ...]:
        """sos/eos/task all end generation (reference: Configuration.swift:29-39)."""
        return (self.speech_token_size, self.speech_token_size + 1,
                self.speech_token_size + 2)


CONFIG_05B = CosyVoiceConfig()


def config_tiny() -> CosyVoiceConfig:
    return CosyVoiceConfig(
        hidden_size=32, num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16,
        intermediate_size=64, text_vocab=300, speech_token_size=40,
        speech_token_extra=8, max_tokens=8,
        flow=flow_config_tiny(), hift=hift_config_tiny(), sample_rate=24000)


# -- init (the reference's tree and scales) -----------------------------------

def _draw_params(cfg: CosyVoiceConfig, normal, zeros, ones) -> dict:
    h, hd = cfg.hidden_size, cfg.head_dim

    def lin(d_in, d_out, bias=True):
        p = {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in))}
        if bias:
            p["bias"] = zeros(d_out)
        return p

    return {
        "text_embed": normal((cfg.text_vocab, h), 0.02),
        "speech_embed": normal((cfg.speech_vocab, h), 0.02),
        "speech_head": lin(h, cfg.speech_vocab),
        "norm": {"weight": ones(h)},
        "layers": [{
            "input_layernorm": {"weight": ones(h)},
            "post_attention_layernorm": {"weight": ones(h)},
            "q_proj": lin(h, cfg.num_heads * hd),
            "k_proj": lin(h, cfg.num_kv_heads * hd),
            "v_proj": lin(h, cfg.num_kv_heads * hd),
            "o_proj": lin(cfg.num_heads * hd, h, bias=False),
            "mlp": {"gate_proj": lin(h, cfg.intermediate_size, bias=False),
                    "up_proj": lin(h, cfg.intermediate_size, bias=False),
                    "down_proj": lin(cfg.intermediate_size, h, bias=False)},
        } for _ in range(cfg.num_layers)],
        "flow": draw_flow_params(cfg.flow, normal, zeros),
        "hift": draw_hift_params(cfg.hift, normal, zeros, ones),
    }


def init_cosyvoice_params(rng: np.random.Generator, cfg: CosyVoiceConfig) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(
        cfg, lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda n: np.zeros((n,), np.float32), lambda n: np.ones((n,), np.float32))


def init_cosyvoice_params_on_device(cfg: CosyVoiceConfig, generator: torch.Generator) -> dict:
    """The same tree drawn on the generator's device."""
    dev = generator.device
    return _draw_params(
        cfg, lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda n: torch.zeros((n,), device=dev), lambda n: torch.ones((n,), device=dev))


# -- stage 1: LLM speech-token generation ------------------------------------

def gumbel_draws(cfg: CosyVoiceConfig, max_tokens: int, generator: torch.Generator):
    """The token loop's noise: two standard Gumbel vectors a step (the
    nucleus draw and the repetition resample's), [max_tokens, 2, vocab]."""
    u = torch.rand((max_tokens, 2, cfg.speech_vocab), generator=generator,
                   device=generator.device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def _nucleus_sample(lg: torch.Tensor, g: torch.Tensor, cfg: CosyVoiceConfig) -> torch.Tensor:
    """top-k → top-p (keep while cum − p ≤ top_p, the top-1 always) →
    Gumbel-max with the draw ``g`` [vocab]."""
    vocab = lg.shape[-1]
    if 0 < cfg.top_k < vocab:
        kth = torch.topk(lg, cfg.top_k).values[..., -1:]
        lg = torch.where(lg < kth, NEG_INF, lg)
    if cfg.top_p < 1.0:
        order = torch.argsort(-lg, stable=True)
        probs = torch.softmax(lg, dim=-1)
        sp = probs[order]
        keep_sorted = (torch.cumsum(sp, dim=-1) - sp) <= cfg.top_p
        keep = torch.zeros((vocab,), dtype=torch.bool, device=lg.device)
        keep[order] = keep_sorted
        lg = torch.where(keep, lg, NEG_INF)
    return torch.argmax(lg + g, dim=-1)


def _sample_token(lg: torch.Tensor, g: torch.Tensor, window: torch.Tensor,
                  cfg: CosyVoiceConfig, ignore_eos: bool) -> torch.Tensor:
    """The reference's sampler: suppress the rows past the stop tokens, mask
    the stop tokens below the minimum length, nucleus-sample with ``g[0]``,
    then resample with ``g[1]`` if the candidate is already in the recent
    window."""
    idx = torch.arange(lg.shape[-1], device=lg.device)
    lg = torch.where(idx >= cfg.fill_token, NEG_INF, lg)
    if ignore_eos:
        lg = torch.where((idx >= cfg.sos_token) & (idx <= cfg.task_id_token), NEG_INF, lg)
    tok = _nucleus_sample(lg, g[0], cfg)
    rep = (window == tok).sum()
    threshold = max(int(cfg.ras_win_size * cfg.ras_tau_r), 1)
    tok_resampled = torch.argmax(torch.where(idx == tok, NEG_INF, lg) + g[1], dim=-1)
    return torch.where(rep >= threshold, tok_resampled, tok)


def llm_generate_tokens(params, cfg: CosyVoiceConfig, text_ids, n_valid: int, gumbel,
                        max_tokens: int, prompt_speech=None, n_prompt: int = 0):
    """Speech tokens for a text prompt.

    text_ids [T_bucket] right-padded text ids, ``n_valid`` of them real;
    ``gumbel`` [max_tokens, 2, speech_vocab] (:func:`gumbel_draws`);
    prompt_speech [P_bucket] FSQ codes for zero-shot cloning, ``n_prompt``
    real. Prompt layout [sos, text…, task_id, prompt…]. Returns (tokens
    [max_tokens] (eos after the last), n, {"steps_run", "done_reads"})."""
    dev = params["text_embed"].device
    text_ids = torch.as_tensor(np.asarray(text_ids), device=dev).long()
    t_bucket = text_ids.shape[0]
    p_bucket = 0 if prompt_speech is None else len(prompt_speech)
    prefix_len = t_bucket + 2 + p_bucket
    max_len = prefix_len + max_tokens
    h = cfg.hidden_size

    # prefix embeddings: sos at 0, text at 1..n, task at n+1, prompt after
    text_part = params["text_embed"][text_ids]                           # [Tb, h]
    emb = torch.zeros((prefix_len, h), dtype=text_part.dtype, device=dev)
    emb[0] = params["speech_embed"][cfg.sos_token]
    emb[1:1 + t_bucket] = text_part
    emb[1 + n_valid] = params["speech_embed"][cfg.task_id_token]
    valid = torch.zeros((max_len,), dtype=torch.bool, device=dev)
    valid[:2 + n_valid] = True
    if n_prompt:
        prompt = torch.as_tensor(np.asarray(prompt_speech)[:n_prompt], device=dev).long()
        emb[2 + n_valid:2 + n_valid + n_prompt] = params["speech_embed"][prompt]
        valid[2 + n_valid:2 + n_valid + n_prompt] = True
    n_prefix = 2 + n_valid + n_prompt

    kv = dict(dtype=acc_dtype(emb.dtype), device=dev)   # fp32 (float64 in a float64 run)
    caches = [tuple(torch.zeros((1, cfg.num_kv_heads, max_len, cfg.head_dim), **kv)
                    for _ in range(2)) for _ in range(cfg.num_layers)]
    cols = torch.arange(max_len, device=dev)

    def forward(x, positions, start, key_valid, rows):
        """``positions`` are semantic (RoPE) positions; the causal mask
        compares cache slots (``rows``), which run ahead of the semantic
        positions once bucket padding leaves gaps in the prefix."""
        mask = torch.where((cols[None, None, None, :] <= rows[:, None, :, None])
                           & key_valid[None, None, None, :], 0.0, NEG_INF).float()
        for p, (kc, vc) in zip(params["layers"], caches):
            x = qwen2_decoder_layer(
                p, x, positions, mask, num_heads=cfg.num_heads,
                num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
                kc=kc, vc=vc, start=start)
        return rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)

    positions = cols[None, :prefix_len]
    hidden = forward(emb[None], positions, 0, valid, positions)
    logits = linear(hidden[:, n_prefix - 1], params["speech_head"]).float()[0]

    min_len = int(np.ceil(np.float32(n_valid) * np.float32(cfg.min_token_text_ratio)))
    max_len_dyn = min(max_tokens, int(np.float32(n_valid) * np.float32(cfg.max_token_text_ratio)) + 1)

    eos = cfg.eos_token
    out = torch.full((max_tokens,), eos, dtype=torch.long, device=dev)
    window = torch.full((cfg.ras_win_size,), -1, dtype=torch.long, device=dev)

    def is_stop(t):
        return (t >= cfg.sos_token) & (t <= cfg.task_id_token)

    tok = _sample_token(logits, gumbel[0], window, cfg, ignore_eos=min_len > 0)
    done = is_stop(tok)
    out[0] = torch.where(done, eos, tok)
    window[0] = tok
    steps_run, reads = 1, 0
    for step in range(1, max_len_dyn):
        if (step - 1) % DONE_CHECK_TOKENS == 0:
            reads += 1
            if bool(done):
                break
        slot = prefix_len + step - 1
        x = params["speech_embed"][tok][None, None]
        pos = cols[None, n_prefix + step - 1:n_prefix + step]
        kv_valid = valid | ((cols >= prefix_len) & (cols < prefix_len + step))
        hidden = forward(x, pos, slot, kv_valid, cols[None, slot:slot + 1])
        logits = linear(hidden[:, 0], params["speech_head"]).float()[0]
        tok = _sample_token(logits, gumbel[step], window, cfg, ignore_eos=step < min_len)
        stop = is_stop(tok)
        out[step] = torch.where(done | stop, out[step], tok)
        window[step % cfg.ras_win_size] = tok
        done = done | stop
        steps_run += 1
    n = (out != eos).sum()
    return out, n, {"steps_run": steps_run, "done_reads": reads}


# -- dialogue parsing ---------------------------------------------------------

_TURN = re.compile(r"^\s*([A-Za-z0-9_]+)\s*:\s*(.+)$")


def parse_dialogue(script: str) -> List[Tuple[str, str]]:
    """'A: hi\\nB: hello' → [("A", "hi"), ("B", "hello")]
    (reference: DialogueSynthesizer parser)."""
    turns = []
    for line in script.splitlines():
        m = _TURN.match(line)
        if m:
            turns.append((m.group(1), m.group(2).strip()))
        elif line.strip() and turns:
            turns[-1] = (turns[-1][0], turns[-1][1] + " " + line.strip())
    return turns


@dataclasses.dataclass
class Voice:
    """A registered cloning voice: CAM++ x-vector + optional ICL prompt."""
    embedding: np.ndarray                      # [192]
    prompt_tokens: Optional[np.ndarray] = None  # [P] FSQ codes of ref audio
    prompt_feat: Optional[np.ndarray] = None    # [P*ratio, 80] ref mel


class CosyVoiceTTS(SpeechGenerationModel):
    """CosyVoice3 on one device. ``params`` is a tree in the JAX package's
    layout (numpy arrays or tensors), carried onto ``device`` in
    ``dtype``; the KV cache is fp32 whatever the dtype, as the
    reference's."""

    def __init__(self, cfg: CosyVoiceConfig, params, tokenizer=None,
                 dtype: torch.dtype = torch.float32, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.tokenizer = tokenizer
        self.params = params_from_jax(params, self.device, dtype)
        self.voices: Dict[str, Voice] = {}
        #: tokens the last LLM loop ran (the first included), and the host
        #: reads of ``done`` it made
        self.last_loop = {"steps_run": 0, "done_reads": 0}
        self._loaded = True

    @classmethod
    def init_random(cls, cfg: Optional[CosyVoiceConfig] = None, seed: int = 0, *,
                    device="cuda", **kw) -> "CosyVoiceTTS":
        """Random weights drawn with numpy from ``seed``."""
        cfg = cfg or config_tiny()
        return cls(cfg, init_cosyvoice_params(np.random.default_rng(seed), cfg),
                   device=device, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[CosyVoiceConfig] = None, seed: int = 0, *,
                              device="cuda", **kw) -> "CosyVoiceTTS":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``:
        the quick way to build the full-size model."""
        cfg = cfg or CONFIG_05B
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_cosyvoice_params_on_device(cfg, generator), device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "FunAudioLLM/CosyVoice3-0.5B", cache_dir=None,
                        offline_mode: bool = False, progress_handler=None, *,
                        dtype: torch.dtype = torch.float32, **kw) -> "CosyVoiceTTS":
        """Load a local checkpoint directory: the upstream llm/flow/hift trio
        (``.pt`` or ``.safetensors``) or a converted
        ``cosyvoice_tpu.safetensors``, plus the tokenizer files if present;
        a model id is found in the cache or fetched (``core/hub.py``)."""
        from ...core.hub import download_weights
        from ...tokenizers.bpe import BPETokenizer
        from .convert import load_or_convert

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        params = load_or_convert(model_dir)
        tokenizer = None
        try:
            tokenizer = BPETokenizer.from_pretrained_dir(model_dir)
        except FileNotFoundError:
            pass
        return cls(CONFIG_05B, params, tokenizer=tokenizer, dtype=dtype, **kw)

    def register_voice(self, name: str, embedding: np.ndarray,
                       prompt_tokens=None, prompt_feat=None) -> None:
        """Voice cloning: register a CAM++ x-vector and optionally the
        reference clip's FSQ codes + flow-mel for zero-shot ICL cloning
        (reference: VoiceCloning.swift)."""
        self.voices[name] = Voice(
            np.asarray(embedding, np.float32)[: self.cfg.flow.spk_embed_dim],
            None if prompt_tokens is None else np.asarray(prompt_tokens, np.int32),
            None if prompt_feat is None else np.asarray(prompt_feat, np.float32))

    def clone_voice(self, name: str, audio: np.ndarray, sample_rate: int = 16000,
                    speaker_model=None) -> None:
        """Embed reference audio with CAM++ and register it as a cloning
        voice (reference: VoiceCloning.swift — CamPlusPlusSpeaker.embed →
        flow spk conditioning). Pass a loaded ``CampPlusSpeaker`` (or any
        object with ``.embed``); defaults to ``CampPlusSpeaker.from_pretrained()``
        on the model's device."""
        if speaker_model is None:
            from ..speaker.campplus import CampPlusSpeaker

            speaker_model = CampPlusSpeaker.from_pretrained(device=self.device)
        emb = speaker_model.embed(np.asarray(audio, np.float32), sample_rate)
        self.register_voice(name, emb)

    # -- internals -------------------------------------------------------------

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # the three stages' draws, each from its own seed
    def _gumbel(self, seed: int) -> torch.Tensor:
        return gumbel_draws(self.cfg, self.cfg.max_tokens, self._generator(seed))

    def _flow_noise(self, seed: int, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._generator(seed), device=self.device)

    def _source_noise(self, seed: int, n_samples: int):
        return source_noise(self.cfg.hift, 1, n_samples, self._generator(seed))

    def _encode_text(self, text: str) -> np.ndarray:
        ids = (self.tokenizer.encode(text) if self.tokenizer
               else [3 + (ord(c) % 64) for c in text])[:256]
        return np.asarray(ids, np.int32)

    def _generate_tokens(self, text: str, voice: Optional[Voice], seed: int):
        ids = self._encode_text(text)
        n = len(ids)
        bucket = max(16, ((n + 15) // 16) * 16)
        arr = np.zeros(bucket, np.int32)
        arr[:n] = ids
        kw = {}
        if voice is not None and voice.prompt_tokens is not None:
            p = voice.prompt_tokens
            pb = max(16, ((len(p) + 15) // 16) * 16)
            parr = np.zeros(pb, np.int32)
            parr[:len(p)] = p
            kw = dict(prompt_speech=parr, n_prompt=len(p))
        gumbel = self._gumbel(seed)
        with torch.inference_mode():
            tokens, n_tok, self.last_loop = llm_generate_tokens(
                self.params, self.cfg, arr, n, gumbel, self.cfg.max_tokens, **kw)
        return tokens.cpu().numpy().astype(np.int32), int(n_tok)

    def _tokens_to_wav(self, tokens: np.ndarray, voice: Optional[Voice], seed: int) -> np.ndarray:
        """flow → mel → vocoder, with token-bucket padding (pad = repeat of
        the last valid token so the 3-frame pre-lookahead sees speech, not
        garbage); outputs sliced to the exact sample count."""
        cfgf = self.cfg.flow
        dev = self.device
        n_tok = len(tokens)
        bucket = max(8, ((n_tok + 7) // 8) * 8)
        padded = np.concatenate([tokens, np.full(bucket - n_tok, tokens[-1], np.int32)])
        kw = {}
        prompt_mel_frames, n_prompt = 0, 0
        if voice is not None:
            kw["spk_embedding"] = torch.as_tensor(voice.embedding, device=dev)[None]
            if voice.prompt_tokens is not None and voice.prompt_feat is not None:
                kw["prompt_tokens"] = torch.as_tensor(voice.prompt_tokens, device=dev)[None]
                kw["prompt_feat"] = torch.as_tensor(voice.prompt_feat, device=dev)[None]
                prompt_mel_frames = voice.prompt_feat.shape[0]
                n_prompt = len(voice.prompt_tokens)
        t_mel = (n_prompt + bucket) * cfgf.token_mel_ratio
        noise = self._flow_noise(seed + 1, (1, t_mel, cfgf.output_size))
        with torch.inference_mode():
            mel = flow_generate(self.params["flow"], cfgf,
                                torch.as_tensor(padded, device=dev)[None], noise, **kw)
            # drop the prompt-mel prefix, keep the bucketed tail; the wav is
            # sliced to the exact count
            mel = mel[:, prompt_mel_frames:prompt_mel_frames + bucket * cfgf.token_mel_ratio]
            src_noise = self._source_noise(seed + 2,
                                           mel.shape[1] * self.cfg.hift.samples_per_frame)
            wav = hift_generate(self.params["hift"], self.cfg.hift, mel, src_noise)
        n_samples = n_tok * cfgf.token_mel_ratio * self.cfg.hift.samples_per_frame
        return wav[0, :n_samples].float().cpu().numpy()

    # -- public API --------------------------------------------------------------

    def synthesize(self, text: str, voice: Optional[str] = None, seed: int = 0,
                   **kwargs) -> AudioChunk:
        v = self.voices.get(voice or "")
        tokens, n_tok = self._generate_tokens(text, v, seed)
        if n_tok == 0:
            return AudioChunk(np.zeros(0, np.float32), self.cfg.sample_rate)
        wav = self._tokens_to_wav(tokens[:n_tok], v, seed)
        return AudioChunk(wav, self.cfg.sample_rate)

    def synthesize_stream(self, text: str, voice: Optional[str] = None, seed: int = 0,
                          chunk_tokens: int = 30, left_context: int = 10, **kwargs):
        """Chunked streaming synthesis (reference: CosyVoice streaming): the
        flow runs over a sliding token window with left context; only the
        new region's samples are emitted. Chunk boundaries re-anchor the
        ODE on the shared left-context tokens, so overlapping frames are
        re-synthesized with fresh context — streamed audio matches offline
        semantically (same tokens, same voice), not bit-exactly."""
        v = self.voices.get(voice or "")
        tokens, n_tok = self._generate_tokens(text, v, seed)
        if n_tok == 0:
            return
        tokens = tokens[:n_tok]
        r = self.cfg.flow.token_mel_ratio
        spf = self.cfg.hift.samples_per_frame
        emitted = 0
        while emitted < n_tok:
            ctx = min(left_context, emitted)
            window = tokens[emitted - ctx: min(emitted + chunk_tokens, n_tok)]
            wav = self._tokens_to_wav(window, v, seed)
            yield AudioChunk(wav[ctx * r * spf:], self.cfg.sample_rate)
            emitted += len(window) - ctx

    def synthesize_dialogue(self, script: str, voices: Optional[Dict[str, str]] = None,
                            gap_s: float = 0.3, **kw) -> AudioChunk:
        """Multi-speaker dialogue synthesis (reference: DialogueSynthesizer)."""
        pieces = []
        gap = np.zeros(int(gap_s * self.cfg.sample_rate), np.float32)
        for speaker, line in parse_dialogue(script):
            voice = (voices or {}).get(speaker, speaker if speaker in self.voices else None)
            chunk = self.synthesize(line, voice=voice, **kw)
            pieces.extend([chunk.samples, gap])
        samples = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        return AudioChunk(samples, self.cfg.sample_rate)

    def warm_up(self) -> None:
        self.synthesize("hi")

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded
