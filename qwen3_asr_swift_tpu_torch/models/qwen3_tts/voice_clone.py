"""Qwen3-TTS voice cloning — port of
``qwen3_asr_swift_tpu/models/qwen3_tts/voice_clone.py``: an x-vector
speaker encoder, the speech-tokenizer encoder (wave → 16 RVQ codes at
12.5 Hz) for in-context cloning, and the LRU cache of processed
references.

The codec encoder mirrors the decoder in reverse: strided causal convs
downsample 1920× to 12.5 Hz, then residual nearest-neighbour search
against the decoder's own codebooks yields the 16 codes, so encode and
decode stay consistent.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import _linear, _norm
from ...ops.fbank import kaldi_fbank
from ...ops.nn import conv1d, layer_norm, linear
from .codec import _conv, causal_conv1d
from .config import CodecDecoderConfig


# ---------------------------------------------------------------------------
# ECAPA-lite speaker encoder (x-vector)
# ---------------------------------------------------------------------------

def init_speaker_encoder(rng: np.random.Generator, num_mels: int = 80, hidden: int = 192,
                         out_dim: int = 192) -> dict:
    """Random speaker-encoder weights in the reference's layout (numpy)."""
    return {
        "in": _conv(rng, 5, num_mels, hidden),
        "block1": _conv(rng, 3, hidden, hidden),
        "block2": _conv(rng, 3, hidden, hidden),
        "attn": _linear(rng, hidden, 1),
        "out": _linear(rng, 2 * hidden, out_dim),
    }


def speaker_embed(params, audio: torch.Tensor) -> torch.Tensor:
    """audio fp32 [S] at 16 kHz → unit-norm x-vector [out_dim] (attentive
    statistics pooling over three causal convs of the Kaldi fbank)."""
    feats = kaldi_fbank(audio.float())[None]                        # [1, T, 80]
    x = torch.relu(causal_conv1d(feats, params["in"]))
    x = x + torch.relu(causal_conv1d(x, params["block1"], dilation=2))
    x = x + torch.relu(causal_conv1d(x, params["block2"], dilation=3))
    w = torch.softmax(linear(x, params["attn"]).float(), dim=1)     # [1, T, 1]
    mean = (x * w).sum(dim=1)
    var = ((x - mean[:, None]) ** 2 * w).sum(dim=1)
    stats = torch.cat([mean, torch.sqrt(var + 1e-6)], dim=-1)
    emb = linear(stats, params["out"])[0]
    return emb / (torch.linalg.vector_norm(emb) + 1e-8)


# ---------------------------------------------------------------------------
# speech tokenizer encoder (wave → 16 codes @12.5 Hz)
# ---------------------------------------------------------------------------

def init_codec_encoder(rng: np.random.Generator, cfg: CodecDecoderConfig) -> dict:
    """Random codec-encoder weights in the reference's layout (numpy); each
    conv's stride is half its kernel width."""
    h = cfg.codebook_dim * 2
    strides = _factor_strides(cfg.samples_per_frame)
    convs = []
    cin = 1
    for i, s in enumerate(strides):
        cout = h if i == len(strides) - 1 else max(16, h // 2)
        convs.append(_conv(rng, 2 * s, cin, cout))
        cin = cout
    return {"convs": convs, "ln": _norm(h, bias=True), "proj": _linear(rng, h, cfg.codebook_dim)}


def _factor_strides(total: int):
    """Greedy factorization of the per-frame sample count into conv strides."""
    strides = []
    rest = total
    for f in (8, 8, 6, 5, 4, 3, 2):
        while rest % f == 0 and rest > 1 and len(strides) < 5:
            strides.append(f)
            rest //= f
        if rest == 1:
            break
    if rest != 1:
        strides.append(rest)
    return strides


def codec_encode(enc_params, codec_params, cfg: CodecDecoderConfig,
                 wave: torch.Tensor) -> torch.Tensor:
    """wave fp32 [S] at 24 kHz → codes int64 [T, num_quantizers] by residual
    nearest-neighbour search against the decoder's RVQ codebooks."""
    frame = cfg.samples_per_frame
    x = F.pad(wave, (0, (-wave.shape[0]) % frame))[None, :, None]
    for c in enc_params["convs"]:
        k = int(c["kernel"].shape[0])
        stride = k // 2
        # the reference's default GELU is the tanh approximation
        x = F.gelu(conv1d(x, c, stride=stride, padding=((k - stride, 0),)), approximate="tanh")
    z = linear(layer_norm(x, enc_params["ln"]["weight"], enc_params["ln"]["bias"]),
               enc_params["proj"])[0].float()                        # [T, codebook_dim]

    def nearest(resid, book):
        d = ((resid ** 2).sum(-1, keepdim=True) - 2 * resid @ book.T
             + (book ** 2).sum(-1)[None])
        return torch.argmin(d, dim=-1)

    sem_book = codec_params["rvq_first"]["codebook"][0].float()
    codes = [nearest(z, sem_book)]
    resid = z - sem_book[codes[0]]
    rest = codec_params["rvq_rest"]["codebook"].float()
    for q in range(cfg.num_quantizers - 1):
        idx = nearest(resid, rest[q])
        codes.append(idx)
        resid = resid - rest[q][idx]
    return torch.stack(codes, dim=-1)


# ---------------------------------------------------------------------------
# reference cache
# ---------------------------------------------------------------------------

class ReferenceAudioCache:
    """LRU cache of processed voice references (reference:
    ReferenceAudioCache.swift)."""

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._store: "collections.OrderedDict[str, Tuple[np.ndarray, str]]" = \
            collections.OrderedDict()

    def put(self, name: str, codes: np.ndarray, text: str) -> None:
        if name in self._store:
            self._store.pop(name)
        self._store[name] = (np.asarray(codes), text)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    def get(self, name: str) -> Optional[Tuple[np.ndarray, str]]:
        if name not in self._store:
            return None
        self._store.move_to_end(name)
        return self._store[name]

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def __len__(self) -> int:
        return len(self._store)
