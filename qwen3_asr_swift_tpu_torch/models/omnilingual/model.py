"""Omnilingual ASR: wav2vec2 encoder + CTC head — port of
``qwen3_asr_swift_tpu/models/omnilingual/model.py``.

Utterance-level norm of the raw waveform over its valid samples → wav2vec2
conv feature extractor (7 strided convs, 512 channels, 20 ms frames; fp32
accumulation cast back, then layer norm and exact GELU) → feature
projection → the 128-tap grouped positional conv with the reference's
asymmetric same-padding → pre-LN transformer encoder, ``encoder_ln`` after
the stack → CTC head → greedy CTC collapse on the host. 40 s input cap.
The convs are ``ops/nn.py::conv1d`` (fp32 tap sums; bf16 ``F.conv1d``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch

from ...core.params import _linear, _norm, _normal, params_from_jax
from ...core.protocols import SpeechRecognitionModel
from ...core.types import TranscriptionResult
from ...device import resolve_device
from ...ops.attention import NEG_INF, sdpa
from ...ops.nn import conv1d, gelu, layer_norm, linear

MAX_SECONDS = 40.0

# wav2vec2 conv feature extractor: (channels, kernel, stride) ×7 → 320× downsample
CONV_SPEC = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
             (512, 3, 2), (512, 2, 2), (512, 2, 2))


@dataclasses.dataclass(frozen=True)
class OmniConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16
    vocab_size: int = 10288
    blank_id: int = 0
    layer_norm_eps: float = 1e-5


CONFIG_300M = OmniConfig(hidden_size=1024, num_layers=24)
CONFIG_1B = OmniConfig(hidden_size=1280, num_layers=48, num_heads=20, ffn_dim=5120)


def config_tiny(vocab: int = 40) -> OmniConfig:
    return OmniConfig(hidden_size=32, num_layers=2, num_heads=2, ffn_dim=64,
                      conv_pos_kernel=16, conv_pos_groups=2, vocab_size=vocab)


def conv_output_length(n_samples: int) -> int:
    l = n_samples
    for _, k, s in CONV_SPEC:
        l = (l - k) // s + 1
    return l


def init_omni_params(rng, cfg: OmniConfig) -> dict:
    """The reference's tree."""
    params = {"feature_extractor": [], "layers": []}
    cin = 1
    for c, k, _ in CONV_SPEC:
        params["feature_extractor"].append(
            {"kernel": _normal(rng, (k, cin, c), 1.0 / np.sqrt(k * cin)), "ln": _norm(c, True)})
        cin = c
    h = cfg.hidden_size
    params["feature_projection"] = {"ln": _norm(512, True), "proj": _linear(rng, 512, h)}
    params["pos_conv"] = {
        "kernel": _normal(rng, (cfg.conv_pos_kernel, h // cfg.conv_pos_groups, h), 0.02),
        "bias": np.zeros((h,), np.float32)}
    params["encoder_ln"] = _norm(h, True)
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn": {n: _linear(rng, h, h) for n in ("q", "k", "v", "o")},
            "ln1": _norm(h, True),
            "ff1": _linear(rng, h, cfg.ffn_dim),
            "ff2": _linear(rng, cfg.ffn_dim, h),
            "ln2": _norm(h, True),
        })
    params["ctc_head"] = _linear(rng, h, cfg.vocab_size)
    return params


def omni_forward(params, cfg: OmniConfig, audio, n_valid_samples: int):
    """audio: [T] (padded) on the device, in the params' dtype or fp32;
    returns (log-probs [F, vocab] fp32, n_valid_frames)."""
    dtype = params["ctc_head"]["kernel"].dtype
    # utterance-level layer norm of the waveform over the valid samples
    t = audio.shape[0]
    valid = torch.arange(t, device=audio.device) < n_valid_samples
    zero = audio.new_zeros(())
    cnt = float(max(n_valid_samples, 1))
    mean = torch.where(valid, audio, zero).sum() / cnt
    var = torch.where(valid, (audio - mean) ** 2, zero).sum() / cnt
    x = torch.where(valid, (audio - mean) * torch.rsqrt(var + 1e-7), zero)

    h = x[None, :, None].to(dtype)                              # [1, T, 1]
    for (_, _, s), p in zip(CONV_SPEC, params["feature_extractor"]):
        h = conv1d(h, {"kernel": p["kernel"]}, stride=s)
        h = layer_norm(h, p["ln"]["weight"], p["ln"]["bias"], cfg.layer_norm_eps)
        h = gelu(h)

    fp = params["feature_projection"]
    h = layer_norm(h, fp["ln"]["weight"], fp["ln"]["bias"], cfg.layer_norm_eps)
    h = linear(h, fp["proj"])                                   # [1, F, H]

    # convolutional position embeddings (grouped conv, same-pad, gelu)
    pc = params["pos_conv"]
    kk = pc["kernel"].shape[0]
    pos = conv1d(h, {"kernel": pc["kernel"]}, padding=((kk // 2, kk - 1 - kk // 2),),
                 groups=cfg.conv_pos_groups) + pc["bias"]
    h = h + gelu(pos)
    # stable-layer-norm wav2vec2 applies encoder.layer_norm AFTER the stack

    f = h.shape[1]
    n_valid_f = conv_output_length(n_valid_samples)
    key_ok = torch.arange(f, device=h.device)[None, :] < n_valid_f
    mask = torch.where(key_ok, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    for p in params["layers"]:
        hh = layer_norm(h, p["ln1"]["weight"], p["ln1"]["bias"], cfg.layer_norm_eps)
        q = linear(hh, p["attn"]["q"]).reshape(1, f, nh, hd).transpose(1, 2)
        k = linear(hh, p["attn"]["k"]).reshape(1, f, nh, hd).transpose(1, 2)
        v = linear(hh, p["attn"]["v"]).reshape(1, f, nh, hd).transpose(1, 2)
        a = sdpa(q, k, v, 1.0 / math.sqrt(hd), mask)
        h = h + linear(a.transpose(1, 2).reshape(1, f, -1), p["attn"]["o"])
        hh = layer_norm(h, p["ln2"]["weight"], p["ln2"]["bias"], cfg.layer_norm_eps)
        h = h + linear(gelu(linear(hh, p["ff1"])), p["ff2"])

    h = layer_norm(h, params["encoder_ln"]["weight"], params["encoder_ln"]["bias"],
                   cfg.layer_norm_eps)
    logits = linear(h[0], params["ctc_head"]).float()
    return torch.log_softmax(logits, dim=-1), n_valid_f


def ctc_greedy_collapse(tokens: np.ndarray, blank_id: int) -> List[int]:
    """Collapse repeats then remove blanks (reference: CTCGreedyDecoder)."""
    out: List[int] = []
    prev = -1
    for t in tokens:
        if t != prev and t != blank_id:
            out.append(int(t))
        prev = t
    return out


class OmnilingualASR(SpeechRecognitionModel):
    """Omnilingual CTC on one device (the card unless the caller asks for
    the CPU). Each clip is zero-padded to its bucket, as in the reference:
    the padded samples are masked out of the waveform norm and the
    attention's keys, but the feature frames they make reach the valid
    frames through the 128-tap positional conv, so the bucket is part of
    the function."""

    BUCKETS_S = (5, 10, 20, 40)

    def __init__(self, cfg: OmniConfig, params, tokenizer=None,
                 dtype: torch.dtype = torch.bfloat16, *, device="cuda"):
        self.cfg = cfg
        self.tokenizer = tokenizer  # SentencePieceModel
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        self._loaded = True

    @classmethod
    def init_random(cls, cfg: Optional[OmniConfig] = None, seed: int = 0,
                    dtype: torch.dtype = torch.float32, *, device="cuda",
                    **kw) -> "OmnilingualASR":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``."""
        cfg = cfg or config_tiny()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_omni_params(gen, cfg), dtype=dtype, device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "facebook/omnilingual-asr-300m", cache_dir=None,
                        offline_mode: bool = False, dtype: torch.dtype = torch.bfloat16,
                        **kw) -> "OmnilingualASR":
        """A checkpoint from a directory, a cached snapshot or a fetch (``core/hub.py``)."""
        from pathlib import Path

        from ...core.hub import download_weights
        from ...core.weights import load_safetensors
        from ...tokenizers.sentencepiece_model import SentencePieceModel
        from .convert import convert_wav2vec2

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        cfg = CONFIG_300M
        params = convert_wav2vec2(load_safetensors(model_dir), cfg)
        spm = sorted(Path(model_dir).glob("*.model"))
        tokenizer = SentencePieceModel.load(spm[0]) if spm else None
        return cls(cfg, params, tokenizer=tokenizer, dtype=dtype, **kw)

    @torch.inference_mode()
    def log_probs(self, audio: np.ndarray):
        """:func:`omni_forward` over the clip zero-padded to its bucket:
        (log-probs [F, vocab] fp32 on the device, valid frames)."""
        bucket = next((s * 16000 for s in self.BUCKETS_S if len(audio) <= s * 16000),
                      self.BUCKETS_S[-1] * 16000)
        padded = np.zeros(bucket, np.float32)
        padded[: len(audio)] = audio
        return omni_forward(self.params, self.cfg, torch.from_numpy(padded).to(self.device),
                            len(audio))

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16000,
                   language: Optional[str] = None, **kwargs) -> TranscriptionResult:
        t0 = time.perf_counter()
        if sample_rate != 16000:
            from ...audio.resample import resample

            audio = resample(audio.astype(np.float32), sample_rate, 16000)
        audio = audio[: int(MAX_SECONDS * 16000)]  # 40 s cap
        duration = len(audio) / 16000
        logp, n_f = self.log_probs(audio)
        logp = logp[:n_f].cpu().numpy()
        tokens = logp.argmax(axis=-1)
        ids = ctc_greedy_collapse(tokens, self.cfg.blank_id)
        text = self.tokenizer.decode(ids) if self.tokenizer else " ".join(map(str, ids))
        conf = float(np.exp(logp.max(axis=-1).mean())) if len(logp) else 0.0
        return TranscriptionResult(text=text, language=language, confidence=conf,
                                   duration=duration, processing_time=time.perf_counter() - t0)

    def warm_up(self) -> None:
        self.transcribe(np.zeros(16000, np.float32))

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded
