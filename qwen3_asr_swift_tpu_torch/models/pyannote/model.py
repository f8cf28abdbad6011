"""Pyannote segmentation-3.0 — port of
``qwen3_asr_swift_tpu/models/pyannote/model.py``.

SincNet (instance norm of the wave → Conv1d(1, 80, k251, s10) → |·| →
MaxPool3 → IN → LeakyReLU, then two Conv1d(k5) + pool + IN + LeakyReLU
stages) → 4-layer BiLSTM, 128 a direction → 2 × Linear(128) → the 7-class
powerset → per-speaker probabilities; the VAD pipeline slides 10 s windows
at a 5 s step over the clip and averages the overlaps.

Every window of a clip goes through one batched forward on the device. The
convs are the port's ``ops/nn.py::conv1d`` (the first, one input channel,
one product over the unfolded windows; the others fp32 tap sums). Each
BiLSTM layer runs both directions in one loop of device ops
(``ops/nn.py::lstm_loop``): each direction's input product is one ``bmm``
over every step, taken before the loop, and a step is one batched
recurrent product and the gates (torch gate order i, f, g, o). The windows are full length, so the backward
direction is a plain reverse in time. The overlap sum is taken on the
host in float64, as the reference takes it.

``init_segmentation_params`` draws with numpy (the tests' twin trees),
``init_segmentation_params_on_device`` with a ``torch.Generator``;
``convert.py`` is a copy of the reference's converter.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.params import params_from_jax
from ...core.protocols import VoiceActivityDetectionModel
from ...core.types import SpeechSegment
from ...device import resolve_device
from ...ops.nn import conv1d, linear, lstm_loop, upcast


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    sample_rate: int = 16000
    sincnet_filters: Tuple[int, ...] = (80, 60, 60)
    sincnet_kernels: Tuple[int, ...] = (251, 5, 5)
    sincnet_strides: Tuple[int, ...] = (10, 1, 1)
    sincnet_pools: Tuple[int, ...] = (3, 3, 3)
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_hidden: int = 128
    linear_layers: int = 2
    num_classes: int = 7          # powerset for ≤3 speakers
    num_speakers: int = 3
    window_s: float = 10.0
    step_ratio: float = 0.5


SEGMENTATION_30 = SegmentationConfig()


def config_tiny() -> SegmentationConfig:
    return SegmentationConfig(
        sincnet_filters=(8, 6, 6), sincnet_kernels=(65, 5, 5),
        lstm_hidden=8, lstm_layers=1, linear_hidden=8, linear_layers=1,
        window_s=1.0,
    )


# powerset classes: 0=∅, 1..3 = solo speakers, 4=(1,2), 5=(1,3), 6=(2,3)
_POWERSET = [(), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2)]


def _powerset_mapping() -> np.ndarray:
    mapping = np.zeros((7, 3), np.float32)
    for cls, members in enumerate(_POWERSET):
        for m in members:
            mapping[cls, m] = 1.0
    return mapping


def powerset_to_speakers(posteriors: torch.Tensor) -> torch.Tensor:
    """[..., 7] softmax → [..., 3] per-speaker probabilities
    (reference: PowersetDecoder.speakerProbabilities)."""
    mapping = torch.from_numpy(_powerset_mapping()).to(posteriors.device, posteriors.dtype)
    return posteriors @ mapping


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _draw_params(cfg: SegmentationConfig, normal, uniform, zeros) -> dict:
    chans = (1,) + cfg.sincnet_filters[:-1]
    params = {"conv": [], "lstm_fwd": [], "lstm_bwd": [], "linear": []}
    for cin, cout, k in zip(chans, cfg.sincnet_filters, cfg.sincnet_kernels):
        params["conv"].append({"kernel": normal((k, cin, cout), 1.0 / np.sqrt(k * cin)),
                               "bias": zeros(cout)})

    def lstm(d_in, d_h):
        s = 1.0 / np.sqrt(d_h)
        return {"wx": uniform((d_in, 4 * d_h), s), "wh": uniform((d_h, 4 * d_h), s),
                "bias": zeros(4 * d_h)}

    d_in = cfg.sincnet_filters[-1]
    for i in range(cfg.lstm_layers):
        src = d_in if i == 0 else 2 * cfg.lstm_hidden
        params["lstm_fwd"].append(lstm(src, cfg.lstm_hidden))
        params["lstm_bwd"].append(lstm(src, cfg.lstm_hidden))
    src = 2 * cfg.lstm_hidden
    for _ in range(cfg.linear_layers):
        params["linear"].append({"kernel": normal((src, cfg.linear_hidden), 1.0 / np.sqrt(src)),
                                 "bias": zeros(cfg.linear_hidden)})
        src = cfg.linear_hidden
    params["classifier"] = {"kernel": normal((src, cfg.num_classes), 1.0 / np.sqrt(src)),
                            "bias": zeros(cfg.num_classes)}
    return params


def init_segmentation_params(rng: np.random.Generator, cfg: SegmentationConfig) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(
        cfg, lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda shape, s: rng.uniform(-s, s, shape).astype(np.float32),
        lambda n: np.zeros((n,), np.float32))


def init_segmentation_params_on_device(cfg: SegmentationConfig,
                                       generator: torch.Generator) -> dict:
    """The same tree drawn on the generator's device."""
    dev = generator.device
    return _draw_params(
        cfg, lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda shape, s: (torch.rand(shape, generator=generator, device=dev) * 2 - 1) * s,
        lambda n: torch.zeros((n,), device=dev))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _instance_norm(x: torch.Tensor, p=None, eps: float = 1e-5) -> torch.Tensor:
    """Per-channel normalisation over time (population variance), with
    optional affine params. x [B, T, C]."""
    xf = upcast(x)
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if p is not None:
        y = y * upcast(p["scale"]) + upcast(p["bias"])
    return y.to(x.dtype)


def _max_pool_t(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, T, C] → [B, T//k, C] max over time; the tail is dropped."""
    t = (x.shape[1] // k) * k
    return x[:, :t].reshape(x.shape[0], t // k, k, x.shape[2]).amax(dim=2)


def sincnet(params, cfg: SegmentationConfig, wave: torch.Tensor) -> torch.Tensor:
    """wave [B, S] → features [B, frames, 60]."""
    x = _instance_norm(wave[:, :, None], params.get("wav_norm"))
    for i, p in enumerate(params["conv"]):
        x = conv1d(x, p, stride=cfg.sincnet_strides[i])
        if i == 0:
            x = x.abs()
        x = _max_pool_t(x, cfg.sincnet_pools[i])
        x = F.leaky_relu(_instance_norm(x, p.get("norm")), 0.01)
    return x


def bilstm(pf, pb, x: torch.Tensor) -> torch.Tensor:
    """One bidirectional LSTM layer over full-length sequences: x [B, T, D]
    → [B, T, 2h] (forward ‖ backward). Both directions step together; each
    one's input product is one ``bmm`` over all steps before the loop."""
    xs = upcast(x).transpose(0, 1)                                 # [T, B, D]
    wx, wh, bias = (torch.stack([upcast(pf[k]), upcast(pb[k])]) for k in ("wx", "wh", "bias"))
    xd = torch.stack([xs, xs.flip(0)])                             # [2, T, B, D]
    gx = torch.bmm(xd.reshape(2, -1, xd.shape[-1]), wx).reshape(*xd.shape[:3], -1)
    y = lstm_loop(gx, wh, bias).to(x.dtype)                        # [2, T, B, h]
    return torch.cat([y[0], y[1].flip(0)], dim=-1).transpose(0, 1)


def segmentation_forward(params, cfg: SegmentationConfig, wave: torch.Tensor) -> torch.Tensor:
    """wave [B, S] → powerset posteriors [B, frames, num_classes] (fp32)."""
    x = sincnet(params, cfg, wave)
    for pf, pb in zip(params["lstm_fwd"], params["lstm_bwd"]):
        x = bilstm(pf, pb, x)
    for p in params["linear"]:
        x = F.leaky_relu(linear(x, p), 0.01)
    return torch.softmax(upcast(linear(x, params["classifier"])), dim=-1)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

class PyannoteSegmentation:
    """Speaker segmentation on one device (the card unless the caller asks
    for the CPU): windows → per-speaker activity tracks. ``params`` is a
    tree in the reference's layout (numpy arrays or tensors)."""

    def __init__(self, cfg: SegmentationConfig, params, dtype: torch.dtype = torch.float32, *,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        #: the last batched forward's BiLSTM loop: {"windows", "frames",
        #: "iterations"} (one iteration a frame a layer, both directions
        #: and every window in it)
        self.last_loop = {"windows": 0, "frames": 0, "iterations": 0}
        self._loaded = True

    @classmethod
    def init_random(cls, cfg: Optional[SegmentationConfig] = None, seed: int = 0, *,
                    device="cuda", **kw) -> "PyannoteSegmentation":
        """Random weights drawn from a ``torch.Generator`` seeded ``seed``
        on the host."""
        cfg = cfg or config_tiny()
        generator = torch.Generator().manual_seed(seed)
        return cls(cfg, init_segmentation_params_on_device(cfg, generator), device=device, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[SegmentationConfig] = None, seed: int = 0, *,
                              device="cuda", **kw) -> "PyannoteSegmentation":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``."""
        cfg = cfg or SEGMENTATION_30
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_segmentation_params_on_device(cfg, generator), device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "pyannote/segmentation-3.0",
                        cache_dir=None, offline_mode: bool = False, **kw):
        """A checkpoint from a directory, a cached snapshot or a fetch (``core/hub.py``)."""
        from ...core.hub import download_weights
        from ...core.weights import load_safetensors
        from .convert import convert_segmentation

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        return cls(SEGMENTATION_30, convert_segmentation(load_safetensors(model_dir),
                                                         SEGMENTATION_30), **kw)

    def frames_per_window(self, window_samples: int) -> int:
        t = window_samples
        for i in range(len(self.cfg.sincnet_kernels)):
            t = (t - self.cfg.sincnet_kernels[i]) // self.cfg.sincnet_strides[i] + 1
            t = t // self.cfg.sincnet_pools[i]
        return t

    def windows(self, audio: np.ndarray) -> Tuple[List[int], np.ndarray]:
        """The window starts and the zero-padded windows [W, win] of a clip
        at the model's rate (reference: VADPipeline sliding windows)."""
        win = int(self.cfg.window_s * self.cfg.sample_rate)
        step = max(1, int(win * self.cfg.step_ratio))
        starts = list(range(0, max(1, len(audio) - win + 1), step))
        if not starts or (starts[-1] + win < len(audio)):
            starts.append(max(0, len(audio) - win))
        windows = np.zeros((len(starts), win), np.float32)
        for i, s in enumerate(starts):
            seg = audio[s: s + win]
            windows[i, : len(seg)] = seg
        return starts, windows

    @torch.inference_mode()
    def window_speakers(self, windows: np.ndarray) -> np.ndarray:
        """[W, win] windows → [W, frames, 3] per-speaker probabilities, all
        windows in one batched forward on the device."""
        wave = torch.from_numpy(np.ascontiguousarray(windows)).to(self.device, self.dtype)
        post = segmentation_forward(self.params, self.cfg, wave)
        self.last_loop = {"windows": post.shape[0], "frames": post.shape[1],
                          "iterations": self.cfg.lstm_layers * post.shape[1]}
        return powerset_to_speakers(post).cpu().numpy()

    def speaker_activity(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        """Sliding-window inference + overlap aggregation → [frames, 3]
        per-speaker probabilities."""
        from ...audio.resample import resample

        if sample_rate != self.cfg.sample_rate:
            audio = resample(np.asarray(audio, np.float32), sample_rate, self.cfg.sample_rate)
        audio = np.asarray(audio, np.float32)
        win = int(self.cfg.window_s * self.cfg.sample_rate)
        starts, windows = self.windows(audio)
        speakers = self.window_speakers(windows)                  # [W, F, 3]

        f_per_win = speakers.shape[1]
        frame_hop = win / f_per_win
        total_frames = int(np.ceil(len(audio) / frame_hop))
        acc = np.zeros((total_frames, self.cfg.num_speakers), np.float64)
        cnt = np.zeros((total_frames, 1), np.float64)
        for i, s in enumerate(starts):
            f0 = int(round(s / frame_hop))
            f1 = min(f0 + f_per_win, total_frames)
            acc[f0:f1] += speakers[i, : f1 - f0]
            cnt[f0:f1] += 1
        return (acc / np.maximum(cnt, 1)).astype(np.float32)

    @property
    def frame_duration(self) -> float:
        win = int(self.cfg.window_s * self.cfg.sample_rate)
        return self.cfg.window_s / self.frames_per_window(win)

    def unload(self):
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self):
        return self._loaded


def binarize(probs: np.ndarray, frame_duration: float, onset: float = 0.5,
             offset: float = 0.35, min_speech_s: float = 0.0,
             min_silence_s: float = 0.0) -> List[Tuple[float, float]]:
    """Hysteresis binarization (reference: PowersetDecoder.binarize)."""
    segments: List[Tuple[float, float]] = []
    active = False
    start = 0.0
    for i, p in enumerate(np.asarray(probs, np.float32)):
        t = i * frame_duration
        if not active and p >= onset:
            active, start = True, t
        elif active and p < offset:
            segments.append((start, t))
            active = False
    if active:
        segments.append((start, len(probs) * frame_duration))
    # merge short silences, drop short speech
    if min_silence_s > 0 and segments:
        merged = [segments[0]]
        for s, e in segments[1:]:
            if s - merged[-1][1] < min_silence_s:
                merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        segments = merged
    if min_speech_s > 0:
        segments = [(s, e) for s, e in segments if e - s >= min_speech_s]
    return segments


class PyannoteVAD(VoiceActivityDetectionModel):
    """VAD on top of segmentation: any-speaker activity → speech segments
    (reference: Sources/SpeechVAD/VADPipeline.swift)."""

    def __init__(self, segmentation: PyannoteSegmentation,
                 onset: float = 0.5, offset: float = 0.35,
                 min_speech_s: float = 0.1, min_silence_s: float = 0.1):
        self.segmentation = segmentation
        self.onset, self.offset = onset, offset
        self.min_speech_s, self.min_silence_s = min_speech_s, min_silence_s

    @classmethod
    def init_random(cls, cfg: Optional[SegmentationConfig] = None, *, device="cuda", **kw):
        return cls(PyannoteSegmentation.init_random(cfg, device=device), **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "pyannote/segmentation-3.0", *, device="cuda",
                        **kw):
        return cls(PyannoteSegmentation.from_pretrained(model_id, device=device), **kw)

    def detect_speech(self, audio: np.ndarray, sample_rate: int = 16000) -> List[SpeechSegment]:
        tracks = self.segmentation.speaker_activity(audio, sample_rate)
        any_speaker = tracks.max(axis=-1)
        segs = binarize(any_speaker, self.segmentation.frame_duration,
                        self.onset, self.offset, self.min_speech_s, self.min_silence_s)
        return [SpeechSegment(start=s, end=e) for s, e in segs]

    def speech_probabilities(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        """Per-frame any-speaker probabilities."""
        tracks = self.segmentation.speaker_activity(audio, sample_rate)
        return tracks.max(axis=-1) if len(tracks) else np.zeros(0, np.float32)

    def warm_up(self):
        self.detect_speech(np.zeros(int(self.segmentation.cfg.window_s
                                        * self.segmentation.cfg.sample_rate), np.float32))

    def unload(self):
        self.segmentation.unload()

    @property
    def is_loaded(self):
        return self.segmentation.is_loaded
