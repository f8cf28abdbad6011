"""FireRedVAD (FSMN voice activity detection) — port of
``qwen3_asr_swift_tpu/models/firered_vad/model.py``.

  fbank [T,80] → LFR stack (m=5, n=1, first-frame left padding) [T,400]
  → affine 400→140 → affine 140→250 → ReLU
  → N × BasicBlock( linear 250→128 (no bias)
                    → depthwise memory conv (causal lorder [+ look-ahead rorder]) + skip
                    → affine 128→250 → ReLU )
  → affine 250→140 → affine 140→output_pdfs → softmax
  speech prob = 1 − P(silence pdfs)

The memory convs are depthwise 1-d convs through the port's
``ops/nn.py::conv1d`` (fp32 tap sums, never cuDNN's TF32), so a whole
utterance scores in one pass of device ops with no recurrence. Two paths:
up to ``max_frames`` rows, one pass of :func:`fused_vad_forward` (fbank,
LFR stack by clamped indices, FSMN with rows past the valid count
masked); above it, :func:`lfr_stack` + :func:`fsmn_forward` in chunks of
``max_frames`` that overlap by the network's receptive field, so chunked
scores equal one pass. The reference pads its one-pass input to a bucket
for a static compiled length; the port runs eagerly and does not pad, and
the clamped indices and the mask make a padded call's valid rows equal
the unpadded one's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import VoiceActivityDetectionModel
from ...core.types import SpeechSegment
from ...device import resolve_device
from ...ops.fbank import kaldi_fbank
from ...ops.nn import conv1d, linear, upcast


@dataclasses.dataclass(frozen=True)
class FireRedVADConfig:
    num_mels: int = 80
    sample_rate: int = 16000
    frame_len: int = 400        # 25 ms
    hop: int = 160              # 10 ms
    lfr_m: int = 5              # stacked frames (input dim = num_mels * lfr_m)
    lfr_n: int = 1              # frame subsampling
    in_affine: int = 140
    linear_dim: int = 250
    proj_dim: int = 128
    num_blocks: int = 4
    lorder: int = 20            # causal memory taps
    rorder: int = 0             # lookahead taps
    out_affine: int = 140
    output_dim: int = 248       # senone pdfs; pdf 0 = silence
    sil_pdfs: Tuple[int, ...] = (0,)
    # post-processing (reference: FireRedVAD.swift:31-35)
    speech_threshold: float = 0.4
    smooth_window: int = 5
    min_speech_s: float = 0.2
    min_silence_s: float = 0.2
    max_frames: int = 6000      # long-audio chunking (FireRedVAD.swift:130)


CONFIG_FIRERED = FireRedVADConfig()


def config_tiny() -> FireRedVADConfig:
    return FireRedVADConfig(num_mels=20, lfr_m=3, in_affine=12, linear_dim=16,
                            proj_dim=8, num_blocks=2, lorder=4, rorder=1,
                            output_dim=4)


def _draw_params(cfg: FireRedVADConfig, normal, zeros) -> dict:
    def lin(d_in, d_out, bias=True):
        p = {"kernel": normal((d_in, d_out), 1.0 / np.sqrt(d_in))}
        if bias:
            p["bias"] = zeros(d_out)
        return p

    params = {"in1": lin(cfg.num_mels * cfg.lfr_m, cfg.in_affine),
              "in2": lin(cfg.in_affine, cfg.linear_dim), "blocks": [],
              "out1": lin(cfg.linear_dim, cfg.out_affine),
              "out2": lin(cfg.out_affine, cfg.output_dim)}
    for _ in range(cfg.num_blocks):
        block = {"linear": lin(cfg.linear_dim, cfg.proj_dim, bias=False),
                 "conv_left": normal((cfg.lorder, 1, cfg.proj_dim), 1.0 / cfg.lorder),
                 "affine": lin(cfg.proj_dim, cfg.linear_dim)}
        if cfg.rorder > 0:
            block["conv_right"] = normal((cfg.rorder, 1, cfg.proj_dim), 1.0 / max(1, cfg.rorder))
        params["blocks"].append(block)
    return params


def init_firered_params(rng: np.random.Generator, cfg: FireRedVADConfig) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(
        cfg, lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda n: np.zeros((n,), np.float32))


def init_firered_params_on_device(cfg: FireRedVADConfig, generator: torch.Generator) -> dict:
    """The same tree drawn on the generator's device."""
    dev = generator.device
    return _draw_params(
        cfg, lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda n: torch.zeros((n,), device=dev))


def lfr_stack(feats: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Low-frame-rate stacking: frame t ← concat(feats[t-(m-1)//2 … ]),
    left-padded by repeating the first frame (the FunASR LFR convention).
    feats [T, D] → [ceil(T/n), D*m]."""
    t = feats.shape[0]
    left = (m - 1) // 2
    padded = torch.cat([feats[:1].expand(left, -1), feats, feats[-1:].expand(m, -1)])
    idx = (torch.arange(0, t, n, device=feats.device)[:, None]
           + torch.arange(m, device=feats.device)[None, :])
    return padded[idx].reshape(idx.shape[0], -1)


def _memory_conv(x: torch.Tensor, w: torch.Tensor, causal: bool) -> torch.Tensor:
    """Depthwise memory conv over time, w [taps, 1, D]. ``causal`` reads
    frames t-taps+1 … t (history with the current frame); otherwise frames
    t+1 … t+taps (look-ahead that skips the current frame)."""
    taps = w.shape[0]
    if causal:
        return conv1d(x, {"kernel": w}, padding=((taps - 1, 0),), groups=w.shape[-1])
    xp = torch.nn.functional.pad(x, (0, 0, 0, taps))[:, 1:]
    return conv1d(xp, {"kernel": w}, groups=w.shape[-1])


def fsmn_forward(params, cfg: FireRedVADConfig, feats: torch.Tensor, valid_rows=None):
    """feats [B, T, mels*lfr_m] → speech prob [B, T] (fp32).

    ``valid_rows`` (an int): the memory convs' inputs past it are zeroed, so
    a padded call's valid rows equal the unpadded call's."""
    x = torch.relu(linear(linear(feats, params["in1"]), params["in2"]))
    mask = None
    if valid_rows is not None:
        mask = (torch.arange(feats.shape[1], device=feats.device) < valid_rows)[None, :, None]
    for p in params["blocks"]:
        h = linear(x, p["linear"])                       # [B,T,proj]
        if mask is not None:
            h = torch.where(mask, h, torch.zeros((), dtype=h.dtype, device=h.device))
        mem = h + _memory_conv(h, p["conv_left"], causal=True)
        if "conv_right" in p:
            mem = mem + _memory_conv(h, p["conv_right"], causal=False)
        x = torch.relu(linear(mem, p["affine"]))
    x = linear(x, params["out1"])
    probs = torch.softmax(upcast(linear(x, params["out2"])), dim=-1)
    sil = probs[..., list(cfg.sil_pdfs)].sum(-1)
    return 1.0 - sil


def fused_vad_forward(params, cfg: FireRedVADConfig, audio: torch.Tensor, n_samples: int):
    """fbank → LFR stack → FSMN over ``audio`` [S] (perhaps right-padded
    past ``n_samples``, the valid count): the LFR repeat padding is taken
    with indices clamped to the valid frames, and rows past the valid count
    are masked inside :func:`fsmn_forward`, so valid rows equal the
    unpadded eager path's."""
    feats = kaldi_fbank(audio, num_bins=cfg.num_mels, frame_len=cfg.frame_len,
                        hop=cfg.hop, sample_rate=cfg.sample_rate)
    t_max = feats.shape[0]
    t_valid = max(1 + (n_samples - cfg.frame_len) // cfg.hop, 0)
    left = (cfg.lfr_m - 1) // 2
    starts = np.arange(0, t_max, cfg.lfr_n)
    idx = np.clip(starts[:, None] + np.arange(cfg.lfr_m)[None, :] - left, 0, max(t_valid - 1, 0))
    stacked = feats[torch.from_numpy(idx).to(feats.device)].reshape(len(starts), -1)
    rows_valid = (t_valid + cfg.lfr_n - 1) // cfg.lfr_n
    return fsmn_forward(params, cfg, stacked[None], valid_rows=rows_valid)[0]


class FireRedVAD(VoiceActivityDetectionModel):
    """FireRedVAD on one device (the card unless the caller asks for the
    CPU). ``params`` is a tree in the reference's layout."""

    def __init__(self, cfg: FireRedVADConfig, params, dtype: torch.dtype = torch.float32, *,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        self._loaded = True
        #: the path of the last ``frame_probabilities`` call ("single" or
        #: "chunked") and its chunks
        self.last_path = ("", 0)

    @classmethod
    def init_random(cls, cfg: Optional[FireRedVADConfig] = None, seed: int = 0, *,
                    device="cuda", **kw) -> "FireRedVAD":
        """Random weights drawn from a ``torch.Generator`` seeded ``seed``
        on the host."""
        cfg = cfg or config_tiny()
        return cls(cfg, init_firered_params_on_device(cfg, torch.Generator().manual_seed(seed)),
                   device=device, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[FireRedVADConfig] = None, seed: int = 0, *,
                              device="cuda", **kw) -> "FireRedVAD":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``."""
        cfg = cfg or CONFIG_FIRERED
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_firered_params_on_device(cfg, generator), device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "aufklarer/FireRedVAD",
                        cache_dir=None, offline_mode: bool = False, **kw):
        """A checkpoint file, or one from a directory, a cached snapshot or a fetch (``core/hub.py``)."""
        from ...core.hub import download_weights
        from .convert import convert_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        cfg, params = convert_checkpoint(model_dir)
        return cls(cfg, params, **kw)

    # -- inference -----------------------------------------------------------

    @torch.inference_mode()
    def frame_probabilities(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        from ...audio.resample import resample

        audio = np.asarray(audio, np.float32)
        if sample_rate != self.cfg.sample_rate:
            audio = resample(audio, sample_rate, self.cfg.sample_rate)
        n_samp = int(audio.shape[0])
        t_valid = max(0, 1 + (n_samp - self.cfg.frame_len) // self.cfg.hop)
        rows_valid = -(-t_valid // self.cfg.lfr_n)
        if rows_valid == 0:
            return np.zeros(0, np.float32)
        wave = torch.from_numpy(audio).to(self.device)
        if rows_valid <= self.cfg.max_frames:
            self.last_path = ("single", 1)
            return fused_vad_forward(self.params, self.cfg, wave, n_samp).cpu().numpy()
        # long-audio chunking (reference FireRedVAD.swift:130-152). Unlike
        # the reference's hard cuts, chunks overlap by the network's total
        # receptive extent and the overlap is discarded, so chunked scores
        # equal the single-pass scores
        feats = kaldi_fbank(wave, num_bins=self.cfg.num_mels,
                            frame_len=self.cfg.frame_len, hop=self.cfg.hop)
        stacked = lfr_stack(feats, self.cfg.lfr_m, self.cfg.lfr_n).to(self.dtype)
        n = stacked.shape[0]
        left = self.cfg.lorder * self.cfg.num_blocks
        right = self.cfg.rorder * self.cfg.num_blocks
        out = []
        for off in range(0, n, self.cfg.max_frames):
            lo = max(0, off - left)
            hi = min(n, off + self.cfg.max_frames + right)
            probs = fsmn_forward(self.params, self.cfg, stacked[lo:hi][None])[0]
            out.append(probs[off - lo: off - lo + self.cfg.max_frames])
        self.last_path = ("chunked", len(out))
        return torch.cat(out).cpu().numpy()

    def detect_speech(self, audio: np.ndarray, sample_rate: int = 16000) -> List[SpeechSegment]:
        probs = self.frame_probabilities(audio, sample_rate)
        if len(probs) == 0:
            return []
        # moving-average smoothing (reference: smoothWindowSize=5)
        w = self.cfg.smooth_window
        if w > 1:
            kernel = np.ones(w) / w
            probs = np.convolve(probs, kernel, mode="same")
        frame_s = self.cfg.hop * self.cfg.lfr_n / self.cfg.sample_rate
        # shared hysteresis/merge/min-duration machinery (onset == offset =
        # the plain threshold this model uses); one implementation with
        # silero/pyannote/sortformer instead of a third hand-rolled copy
        from ..pyannote.model import binarize

        segs = binarize(probs, frame_s,
                        onset=self.cfg.speech_threshold,
                        offset=self.cfg.speech_threshold,
                        min_speech_s=self.cfg.min_speech_s,
                        min_silence_s=self.cfg.min_silence_s)
        return [SpeechSegment(start=s, end=e) for s, e in segs]

    def speech_probabilities(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        return self.frame_probabilities(np.asarray(audio, np.float32), sample_rate)

    def warm_up(self):
        self.detect_speech(np.zeros(self.cfg.sample_rate, np.float32))

    def unload(self):
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self):
        return self._loaded
