"""VibeVoice Realtime TTS on one device — split Qwen2 LM + diffusion head +
σ-VAE; port of ``qwen3_asr_swift_tpu/models/vibevoice/model.py``.

- A 24-layer Qwen2 backbone split into ``language_model`` (the bottom 4
  layers, no final norm) and ``tts_language_model`` (the top 20 + norm);
  text flows bottom → top with an input-type embedding a position (1 =
  text, 0 = speech).
- Each frame, the TTS LM's hidden state conditions (a) the AdaLN diffusion
  head, sampled with DPM-Solver++ 2M and CFG against a parallel negative
  stream (prompt: the one negative-text token), and (b) a binary EOS
  classifier (fc1 → ReLU → fc2 → σ > 0.5).
- Latents map to the σ-VAE decoder's space by ``latent / scale − bias``
  and decode to 24 kHz audio (``tokenizer.py``).

The frame loop (:func:`generate_frames`) runs device ops only and reads the
EOS flag on the host every :data:`EOS_CHECK_FRAMES` frames; frames after
the stop record nothing, so the latents and the frame count do not depend
on that cadence. The start of each frame's DPM solve comes from the
caller ([max_frames, latent]); the public methods draw it from a
``torch.Generator`` on the model's device seeded with ``seed`` (``seed +
i`` for chunk i of :meth:`VibeVoiceTTS.generate_long`), as the reference
keys its draws.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import params_from_jax
from ...core.protocols import SpeechGenerationModel
from ...core.types import AudioChunk
from ...device import resolve_device
from ...ops.attention import NEG_INF
from ...ops.nn import acc_dtype, linear, rms_norm
from ...ops.qwen2 import qwen2_decoder_layer
from .diffusion import DiffusionConfig, diffusion_config_tiny, dpm_solve, draw_diffusion_params
from .tokenizer import (TokenizerConfig, decode_chunked, draw_tokenizer_params, encode,
                        tokenizer_config_tiny)

NEGATIVE_TEXT_ID = 151655
SPEECH_START_ID = 151652
SPEECH_END_ID = 151653
SPEECH_DIFFUSION_ID = 151654

#: reference: VibeVoiceTTSModel.systemPromptVibeVoice (the upstream
#: processor's system prompt; encoded with BOS)
SYSTEM_PROMPT = (" Transform the text provided by various speakers into "
                 "speech output, utilizing the distinct voice of each "
                 "respective speaker.\n")

#: the EOS flag is read on the host every this many frames (the frame loop
#: otherwise never syncs); what a frame records does not depend on it
EOS_CHECK_FRAMES = 8


@dataclasses.dataclass(frozen=True)
class VibeVoiceConfig:
    hidden_size: int = 896          # Realtime-0.5B Qwen2 backbone
    num_layers: int = 24
    tts_backbone_layers: int = 20   # top layers form the TTS LM
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 4864
    vocab_size: int = 151936
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    tokenizer: TokenizerConfig = dataclasses.field(default_factory=TokenizerConfig)
    sample_rate: int = 24000
    max_frames: int = 750
    negative_text_id: int = NEGATIVE_TEXT_ID
    speech_start_id: int = SPEECH_START_ID
    speech_end_id: int = SPEECH_END_ID
    speech_diffusion_id: int = SPEECH_DIFFUSION_ID

    @property
    def lm_layers(self) -> int:
        return self.num_layers - self.tts_backbone_layers

    @property
    def latent_dim(self) -> int:
        return self.diffusion.latent_size

    @property
    def vae_upsample(self) -> int:
        return self.tokenizer.total_ratio


CONFIG_05B = VibeVoiceConfig()


def config_tiny() -> VibeVoiceConfig:
    tok = tokenizer_config_tiny()
    diff = dataclasses.replace(diffusion_config_tiny(), latent_size=tok.vae_dim,
                               hidden_size=32)
    return VibeVoiceConfig(
        hidden_size=32, num_layers=3, tts_backbone_layers=2, num_heads=2,
        num_kv_heads=1, head_dim=16, intermediate_size=64, vocab_size=300,
        diffusion=diff, tokenizer=tok, max_frames=8, negative_text_id=299,
        speech_start_id=296, speech_end_id=297, speech_diffusion_id=298)


# -- init (the reference's tree and scales) -----------------------------------

def _draw_params(cfg: VibeVoiceConfig, normal, zeros, ones, full) -> dict:
    h, hd = cfg.hidden_size, cfg.head_dim

    def lin(d_in, d_out, bias=True):
        p = {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in))}
        if bias:
            p["bias"] = zeros(d_out)
        return p

    def layer():
        return {
            "input_layernorm": {"weight": ones(h)},
            "post_attention_layernorm": {"weight": ones(h)},
            "q_proj": lin(h, cfg.num_heads * hd),
            "k_proj": lin(h, cfg.num_kv_heads * hd),
            "v_proj": lin(h, cfg.num_kv_heads * hd),
            "o_proj": lin(cfg.num_heads * hd, h, bias=False),
            "mlp": {"gate_proj": lin(h, cfg.intermediate_size, bias=False),
                    "up_proj": lin(h, cfg.intermediate_size, bias=False),
                    "down_proj": lin(cfg.intermediate_size, h, bias=False)},
        }

    return {
        "embed_tokens": normal((cfg.vocab_size, h), 0.02),
        "tts_input_types": normal((2, h), 0.02),
        "lm_layers": [layer() for _ in range(cfg.lm_layers)],
        "tts_layers": [layer() for _ in range(cfg.tts_backbone_layers)],
        "tts_norm": {"weight": ones(h)},
        "acoustic_connector": {"fc1": lin(cfg.latent_dim, h), "norm": {"weight": ones(h)},
                               "fc2": lin(h, h)},
        "eos_classifier": {"fc1": lin(h, h), "fc2": lin(h, 1)},
        "prediction_head": draw_diffusion_params(cfg.diffusion, normal, ones),
        "acoustic_tokenizer": draw_tokenizer_params(cfg.tokenizer, normal, zeros, ones, full),
        "speech_scaling_factor": full(None, 1.0),
        "speech_bias_factor": full(None, 0.0),
    }


def init_vibevoice_params(rng: np.random.Generator, cfg: VibeVoiceConfig) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(
        cfg, lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda n: np.zeros((n,), np.float32), lambda n: np.ones((n,), np.float32),
        lambda n, v: np.full(() if n is None else (n,), v, np.float32))


def init_vibevoice_params_on_device(cfg: VibeVoiceConfig, generator: torch.Generator) -> dict:
    """The same tree drawn on the generator's device."""
    dev = generator.device
    return _draw_params(
        cfg, lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda n: torch.zeros((n,), device=dev), lambda n: torch.ones((n,), device=dev),
        lambda n, v: torch.full(() if n is None else (n,), v, device=dev))


# -- forward pieces ---------------------------------------------------------------

def acoustic_connect(p, latent: torch.Tensor) -> torch.Tensor:
    """SpeechConnector: fc1 → RMSNorm → fc2."""
    x = linear(latent, p["fc1"])
    x = rms_norm(x, p["norm"]["weight"], 1e-6)
    return linear(x, p["fc2"])


def eos_probability(p, hidden: torch.Tensor) -> torch.Tensor:
    h = F.relu(linear(hidden, p["fc1"]))
    return torch.sigmoid(linear(h, p["fc2"]).float())


def _layer_forward(lp, x, positions, mask, cfg: VibeVoiceConfig, kc=None, vc=None, start=0):
    return qwen2_decoder_layer(
        lp, x, positions, mask, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
        kc=kc, vc=vc, start=start)


def lm_forward(p, cfg: VibeVoiceConfig, embeds: torch.Tensor, valid: torch.Tensor):
    """The bottom ``lm_layers`` over a self-contained prompt (no cache; no
    final norm). embeds [B, T, H], valid [B, T] bool."""
    t = embeds.shape[1]
    vi = valid.long()
    positions = (torch.cumsum(vi, dim=1) - 1) * vi
    ar = torch.arange(t, device=embeds.device)
    mask = torch.where((ar[None, None, :] <= ar[None, :, None]) & valid[:, None, :],
                       0.0, NEG_INF).float()[:, None]
    x = embeds
    for lp in p["lm_layers"]:
        x = _layer_forward(lp, x, positions, mask, cfg)
    return x


def frame_starts(cfg: VibeVoiceConfig, max_frames: int, generator: torch.Generator):
    """The start of each frame's DPM solve, standard normal [max_frames,
    latent]."""
    return torch.randn((max_frames, cfg.latent_dim), generator=generator,
                       device=generator.device)


def generate_frames(p, cfg: VibeVoiceConfig, ids, valid, type_ids, voice_latents,
                    audio_start: int, starts: torch.Tensor, max_frames: int,
                    num_inference_steps: int, cfg_scale: float):
    """Dual-stream prefill, then the frame loop.

    ids [T_bucket] the structured prompt with the voice placeholder block at
    ``audio_start``; ``valid`` and ``type_ids`` (text 1 / speech 0) are
    [T_bucket] arrays built on the host; voice_latents [V_bucket, latent]
    overwrite the placeholder block's embeddings, and the merged sequence
    runs through the base LM before the type embeddings and the TTS
    backbone. ``starts`` [max_frames, latent] (:func:`frame_starts`).
    Returns (latents [max_frames, latent], n_frames,
    {"frames_run", "eos_reads"})."""
    dev = p["embed_tokens"].device
    dtype = p["embed_tokens"].dtype
    ids = torch.as_tensor(np.asarray(ids), device=dev).long()
    valid = torch.as_tensor(np.asarray(valid), device=dev)[None]
    type_ids = torch.as_tensor(np.asarray(type_ids), device=dev).long()
    voice_latents = torch.as_tensor(np.asarray(voice_latents), device=dev)
    t_bucket, v_bucket = ids.shape[0], voice_latents.shape[0]
    prefix_len = t_bucket
    max_len = prefix_len + max_frames

    # ---- positive stream prefill ----
    embeds = p["embed_tokens"][ids][None]
    if v_bucket:
        voice = acoustic_connect(p["acoustic_connector"], voice_latents.to(dtype))
        embeds = embeds.clone()
        embeds[0, audio_start:audio_start + v_bucket] = voice.to(embeds.dtype)
    lm_hidden = lm_forward(p, cfg, embeds, valid)
    embeds = lm_hidden + p["tts_input_types"][type_ids][None]

    vi = valid.long()
    positions = (torch.cumsum(vi, dim=1) - 1) * vi
    n_prefix = vi.sum()
    kv = dict(dtype=acc_dtype(dtype), device=dev)      # fp32 caches (float64 in a float64 run)
    caches = [tuple(torch.zeros((1, cfg.num_kv_heads, max_len, cfg.head_dim), **kv)
                    for _ in range(2)) for _ in range(cfg.tts_backbone_layers)]
    zeros_f = torch.zeros((max_frames,), dtype=positions.dtype, device=dev)
    cols_pos = torch.cat([positions[0], zeros_f])
    prefix_valid = torch.cat([valid[0], torch.zeros((max_frames,), dtype=torch.bool, device=dev)])
    mask = torch.where((cols_pos[None, None, None, :] <= positions[:, None, :, None])
                       & prefix_valid[None, None, None, :], 0.0, NEG_INF).float()
    x = embeds
    for lp, (kc, vc) in zip(p["tts_layers"], caches):
        x = _layer_forward(lp, x, positions, mask, cfg, kc, vc, 0)
    x = rms_norm(x, p["tts_norm"]["weight"], cfg.rms_norm_eps)
    # the last valid position (padding sits inside the prefix)
    last_idx = torch.argmax(positions[0] * vi[0])
    hidden = x[:, last_idx]

    # ---- negative stream prefill (the one negative-text token) ----
    neg_embeds = p["embed_tokens"][cfg.negative_text_id][None, None]
    neg_lm = lm_forward(p, cfg, neg_embeds, torch.ones((1, 1), dtype=torch.bool, device=dev))
    neg_embeds = neg_lm + p["tts_input_types"][1][None, None]
    neg_max = 1 + max_frames
    neg_caches = [tuple(torch.zeros((1, cfg.num_kv_heads, neg_max, cfg.head_dim), **kv)
                        for _ in range(2)) for _ in range(cfg.tts_backbone_layers)]
    nidx = torch.arange(neg_max, device=dev)
    neg_mask = torch.where(nidx < 1, 0.0, NEG_INF).float()[None, None, None, :]
    xn = neg_embeds
    zero_pos = torch.zeros((1, 1), dtype=torch.long, device=dev)
    for lp, (kc, vc) in zip(p["tts_layers"], neg_caches):
        xn = _layer_forward(lp, xn, zero_pos, neg_mask, cfg, kc, vc, 0)
    neg_hidden = rms_norm(xn, p["tts_norm"]["weight"], cfg.rms_norm_eps)[:, 0]

    latents_out = torch.zeros((max_frames, cfg.latent_dim), **kv)
    type0 = p["tts_input_types"][0][None, None]
    idx = torch.arange(max_len, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_frames = torch.zeros((), dtype=torch.long, device=dev)
    frames_run, reads = 0, 0
    for step in range(max_frames):
        if step and step % EOS_CHECK_FRAMES == 0:
            reads += 1
            if bool(done):
                break
        latent = dpm_solve(p["prediction_head"], cfg.diffusion, hidden, starts[step:step + 1],
                           neg_condition=neg_hidden, num_inference_steps=num_inference_steps,
                           cfg_scale=cfg_scale)                                  # [1, D]
        latents_out[step] = torch.where(done, latents_out[step], latent[0])
        n_frames = n_frames + (~done).long()
        emb = acoustic_connect(p["acoustic_connector"], latent.to(dtype))[:, None] + type0

        # positive stream step
        pos = (n_prefix + step).reshape(1, 1)
        kv_valid = prefix_valid | ((idx >= prefix_len) & (idx < prefix_len + step + 1))
        m = torch.where(kv_valid, 0.0, NEG_INF).float()[None, None, None, :]
        xs = emb
        for lp, (kc, vc) in zip(p["tts_layers"], caches):
            xs = _layer_forward(lp, xs, pos, m, cfg, kc, vc, prefix_len + step)
        hidden = rms_norm(xs, p["tts_norm"]["weight"], cfg.rms_norm_eps)[:, 0]

        # negative stream step
        npos = nidx[None, 1 + step:2 + step]
        nm = torch.where(nidx < 2 + step, 0.0, NEG_INF).float()[None, None, None, :]
        xn = emb
        for lp, (kc, vc) in zip(p["tts_layers"], neg_caches):
            xn = _layer_forward(lp, xn, npos, nm, cfg, kc, vc, 1 + step)
        neg_hidden = rms_norm(xn, p["tts_norm"]["weight"], cfg.rms_norm_eps)[:, 0]

        done = done | (eos_probability(p["eos_classifier"], hidden)[0, 0] > 0.5)
        frames_run += 1
    return latents_out, n_frames, {"frames_run": frames_run, "eos_reads": reads}


class VibeVoiceTTS(SpeechGenerationModel):
    """VibeVoice Realtime on one device. ``params`` is a tree in the JAX
    package's layout (numpy arrays or tensors), carried onto ``device`` in
    ``dtype``; the KV caches are fp32 whatever the dtype, as the
    reference's (float64 in a float64 run)."""

    def __init__(self, cfg: VibeVoiceConfig, params, tokenizer=None,
                 dtype: torch.dtype = torch.float32, num_inference_steps: Optional[int] = None,
                 cfg_scale: Optional[float] = None, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        self.num_inference_steps = num_inference_steps or cfg.diffusion.ddpm_num_inference_steps
        self.cfg_scale = cfg.diffusion.cfg_scale if cfg_scale is None else cfg_scale
        #: frames the last frame loop ran, and the host reads of the EOS flag
        self.last_loop = {"frames_run": 0, "eos_reads": 0}
        self._loaded = True

    @classmethod
    def init_random(cls, cfg: Optional[VibeVoiceConfig] = None, seed: int = 0, *,
                    device="cuda", **kw) -> "VibeVoiceTTS":
        """Random weights drawn with numpy from ``seed``."""
        cfg = cfg or config_tiny()
        return cls(cfg, init_vibevoice_params(np.random.default_rng(seed), cfg),
                   device=device, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[VibeVoiceConfig] = None, seed: int = 0, *,
                              device="cuda", **kw) -> "VibeVoiceTTS":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``:
        the quick way to build the full-size model."""
        cfg = cfg or CONFIG_05B
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_vibevoice_params_on_device(cfg, generator), device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "microsoft/VibeVoice-Realtime-0.5B",
                        cache_dir=None, offline_mode: bool = False, progress_handler=None, *,
                        dtype: torch.dtype = torch.float32, **kw) -> "VibeVoiceTTS":
        """Load a local checkpoint directory in the upstream safetensors
        layout (and its tokenizer files, if present). Hub download is not
        ported."""
        from ...core.hub import download_weights
        from ...tokenizers.bpe import BPETokenizer
        from .convert import convert_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        params = convert_checkpoint(model_dir, CONFIG_05B)
        tokenizer = None
        try:
            tokenizer = BPETokenizer.from_pretrained_dir(model_dir)
        except FileNotFoundError:
            pass
        return cls(CONFIG_05B, params, tokenizer=tokenizer, dtype=dtype, **kw)

    # -- internals ---------------------------------------------------------------

    def _starts(self, seed: int, max_frames: int) -> torch.Tensor:
        return frame_starts(self.cfg, max_frames,
                            torch.Generator(device=self.device).manual_seed(seed))

    def _load_voice(self, voice: Optional[str]) -> np.ndarray:
        if voice and Path(voice).exists():
            return np.load(voice)["latents"].astype(np.float32)
        return np.zeros((0, self.cfg.latent_dim), np.float32)

    def _enc(self, s: str):
        return (self.tokenizer.encode(s) if self.tokenizer
                else [3 + (ord(c) % 64) for c in s])

    def _build_prompt(self, text: str, v_bucket: int, n_voice: int):
        """The reference's structured prompt (VibeVoiceTTSModel.swift:
        439-471): system | speaker exemplar with the speech delimiters
        around the vae placeholder block | text input | speech-output cue
        | <speech_start>. Returns (ids, valid, type_ids, audio_start)."""
        cfg = self.cfg
        pre = list(self._enc(SYSTEM_PROMPT))
        if v_bucket:
            pre += self._enc(" Speaker 0:") + [cfg.speech_start_id]
        audio_start = len(pre)
        mid = [cfg.speech_diffusion_id] * v_bucket
        post = ([cfg.speech_end_id] + self._enc("\n")) if v_bucket else []
        post += self._enc(f" Text input:\n Speaker 0:{text}\n")
        post += self._enc(" Speech output:\n") + [cfg.speech_start_id]
        ids = np.asarray(pre + mid + post, np.int32)
        valid = np.ones(len(ids), bool)
        valid[audio_start + n_voice : audio_start + v_bucket] = False
        type_ids = np.ones(len(ids), np.int32)         # text = 1
        type_ids[audio_start : audio_start + v_bucket] = 0  # speech = 0
        return ids, valid, type_ids, audio_start

    def _run(self, text: str, voice_latents: np.ndarray, max_frames: int, seed: int):
        v = len(voice_latents)
        v_bucket = 0 if v == 0 else max(8, ((v + 7) // 8) * 8)
        vl = np.zeros((v_bucket, self.cfg.latent_dim), np.float32)
        vl[:v] = voice_latents[:v_bucket]
        ids, valid, type_ids, a0 = self._build_prompt(text, v_bucket, v)
        n = len(ids)
        bucket = max(16, ((n + 15) // 16) * 16)
        arr = np.zeros(bucket, np.int32)
        arr[:n] = ids
        varr = np.zeros(bucket, bool)
        varr[:n] = valid
        tarr = np.ones(bucket, np.int32)
        tarr[:n] = type_ids
        starts = self._starts(seed, max_frames)
        with torch.inference_mode():
            latents, n_f, self.last_loop = generate_frames(
                self.params, self.cfg, np.minimum(arr, self.cfg.vocab_size - 1), varr, tarr,
                vl, a0, starts, max_frames, self.num_inference_steps, self.cfg_scale)
        return latents.cpu().numpy(), int(n_f)

    def _latents_to_audio(self, lm_latents: np.ndarray) -> np.ndarray:
        """LM-space latents → decoder space → waveform (scaled = latent /
        scale − bias)."""
        scale = float(self.params["speech_scaling_factor"])
        bias = float(self.params["speech_bias_factor"])
        dec_latents = lm_latents / scale - bias
        n = len(dec_latents)
        bucket = max(8, ((n + 7) // 8) * 8)
        padded = np.zeros((bucket, self.cfg.latent_dim), np.float32)
        padded[:n] = dec_latents
        with torch.inference_mode():
            wav = decode_chunked(self.params["acoustic_tokenizer"], self.cfg.tokenizer,
                                 torch.from_numpy(padded).to(self.device, self.dtype)[None])
        return wav[0, : n * self.cfg.vae_upsample].float().cpu().numpy()

    # -- public API ----------------------------------------------------------------

    def synthesize(self, text: str, voice: Optional[str] = None,
                   max_frames: Optional[int] = None, seed: int = 0, **kwargs) -> AudioChunk:
        voice_latents = self._load_voice(voice)
        latents, n_f = self._run(text, voice_latents, max_frames or self.cfg.max_frames, seed)
        if n_f == 0:
            return AudioChunk(np.zeros(0, np.float32), self.cfg.sample_rate)
        return AudioChunk(self._latents_to_audio(latents[:n_f]), self.cfg.sample_rate)

    def generate_long(self, text: str, voice: Optional[str] = None,
                      max_chars_per_chunk: int = 300, seed: int = 0,
                      carry_frames: int = 8, **kwargs) -> AudioChunk:
        """Long-form synthesis: the text chunked on sentence boundaries, each
        chunk conditioned on the true tail latents of the previous one (in
        memory, no temporary files)."""
        from ...core.text_chunker import chunk_text

        pieces = chunk_text(text, max_chars=max_chars_per_chunk)
        if not pieces:
            return AudioChunk(np.zeros(0, np.float32), self.cfg.sample_rate)
        waves = []
        carry = self._load_voice(voice)
        max_frames = kwargs.pop("max_frames", None) or self.cfg.max_frames
        for i, piece in enumerate(pieces):
            latents, n_f = self._run(piece, carry, max_frames, seed + i)
            if n_f == 0:
                continue
            lm_latents = latents[:n_f]
            waves.append(self._latents_to_audio(lm_latents))
            carry = lm_latents[-carry_frames:]
        return AudioChunk(np.concatenate(waves) if waves else np.zeros(0, np.float32),
                          self.cfg.sample_rate)

    def encode_voice(self, audio: np.ndarray, transcript: str, output: str) -> Path:
        """Mint a voice cache from reference audio through the σ-VAE encoder;
        stores LM-space latents ((mean + bias) · scale, the inverse of the
        decode mapping)."""
        spf = self.cfg.vae_upsample
        n = max(1, len(audio) // spf) * spf
        padded = np.zeros(n, np.float32)
        padded[: min(len(audio), n)] = audio[:n]
        with torch.inference_mode():
            mean = encode(self.params["acoustic_tokenizer"], self.cfg.tokenizer,
                          torch.from_numpy(padded).to(self.device, self.dtype)[None])[0]
        mean = mean.float().cpu().numpy()
        scale = float(self.params["speech_scaling_factor"])
        bias = float(self.params["speech_bias_factor"])
        lm_latents = (mean + bias) * scale
        out = Path(output)
        np.savez(out, latents=lm_latents[:64].astype(np.float32), transcript=transcript)
        return out

    def warm_up(self) -> None:
        self.synthesize("hi", max_frames=2)

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded
