"""CAM++ speaker embedding (the 3D-Speaker D-TDNN) — port of
``qwen3_asr_swift_tpu/models/speaker/campplus.py``.

Frontend: Povey window, pre-emphasis 0.97, 400/160 framing zero-padded to
a 512-point DFT (two matmuls), 80 HTK-mel bins (fmin 20) with Slaney area
normalisation, ``log(max(x, 1e-10))``, then mean subtraction over the valid
frames (CMN). Short audio is tiled and long audio centre-cropped to 500
frames.

Network: the FCM head (3×3 convs, 2 + 2 residual blocks with stride 2 on
the mel axis, a stride-(2, 1) conv) → TDNN (k 5, stride 2) → 3 CAM-dense
blocks (12/24/16 layers, growth 32, bottleneck 128, dilations 1/2/2),
each dense layer's output concatenated to its input, transit layers
halving the channels → statistics pooling (mean ‖ population std clipped
at 1e-8) → dense 1×1 → affine-free batch norm → 192-d (not normalised).

The 2-d convs (NCHW, OIHW weights) are the port's
``ops/nn.py::conv2d_nchw`` (fp32 sums of tap matmuls) on the weights in its
HWIO layout; the 1-d convs (NCL, OIH) its ``conv1d``. The segment pooling
is an average pool in ceil mode: the last segment divides by its own
count. ``embed_batch`` runs one fbank and one D-TDNN forward for a whole
batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import SpeakerEmbeddingModel
from ...device import resolve_device
from ...ops.nn import conv1d, conv2d_nchw


@dataclasses.dataclass(frozen=True)
class CampPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4            # bottleneck = bn_size * growth_rate
    init_channels: int = 128
    m_channels: int = 32        # FCM width
    block_layers: Tuple[int, ...] = (12, 24, 16)
    block_dilations: Tuple[int, ...] = (1, 2, 2)
    kernel_size: int = 3
    seg_len: int = 100
    target_frames: int = 500
    sample_rate: int = 16000

    @property
    def head_out(self) -> int:
        return self.m_channels * (self.feat_dim // 8)


CONFIG_CAMPPLUS = CampPlusConfig()


def config_tiny() -> CampPlusConfig:
    return CampPlusConfig(feat_dim=16, embedding_size=8, growth_rate=4,
                          bn_size=2, init_channels=8, m_channels=4,
                          block_layers=(2, 2), block_dilations=(1, 2),
                          seg_len=5, target_frames=40)


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def _campplus_dft(frame_len=400, n_fft=512):
    i = np.arange(frame_len, dtype=np.float64)
    povey = (0.5 - 0.5 * np.cos(2 * np.pi * i / (frame_len - 1))) ** 0.85
    n = np.arange(frame_len)
    k = np.arange(n_fft // 2 + 1)
    phase = 2 * np.pi * np.outer(n, k) / n_fft
    return ((povey[:, None] * np.cos(phase)).astype(np.float32),
            (povey[:, None] * -np.sin(phase)).astype(np.float32))


@functools.lru_cache(maxsize=2)
def _htk_mel_banks(n_mels=80, n_fft=512, sr=16000, fmin=20.0):
    """HTK mel triangles with Slaney 2/(f_hi−f_lo) area normalization
    (CamPlusPlusMelExtractor.swift:44-96)."""
    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    freqs = np.arange(n_bins) * sr / n_fft
    pts = mel2hz(np.linspace(hz2mel(fmin), hz2mel(sr / 2), n_mels + 2))
    fb = np.zeros((n_bins, n_mels))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        tri = np.maximum(0.0, np.minimum(up, down))
        fb[:, m] = tri * (2.0 / (hi - lo))
    return fb.astype(np.float32)


def campplus_fbank(audio: torch.Tensor, n_valid_samples=None,
                   cfg: CampPlusConfig = CONFIG_CAMPPLUS) -> torch.Tensor:
    """audio [..., T] at 16 kHz → [..., n_frames, feat_dim] CMN'd log-mel.

    ``n_valid_samples`` (an int, or [...] integers) for bucket-padded audio:
    the CMN statistics cover only the valid frames and padded rows are 0."""
    frame_len, hop = 400, 160
    t = audio.shape[-1]
    n_frames = max(0, 1 + (t - frame_len) // hop)
    if n_frames == 0:
        return audio.new_zeros((*audio.shape[:-1], 0, cfg.feat_dim))
    dev = audio.device
    idx = (torch.arange(n_frames, device=dev)[:, None] * hop
           + torch.arange(frame_len, device=dev)[None, :])
    frames = audio[..., idx]
    shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - 0.97 * shifted
    cos_m, sin_m = (torch.from_numpy(m).to(dev, audio.dtype) for m in _campplus_dft(frame_len))
    re, im = frames @ cos_m, frames @ sin_m
    power = re * re + im * im
    fb = torch.from_numpy(_htk_mel_banks(cfg.feat_dim, 512, cfg.sample_rate)).to(dev, audio.dtype)
    mel = torch.log(torch.clamp(power @ fb, min=1e-10))
    if n_valid_samples is None:
        return mel - mel.mean(dim=-2, keepdim=True)           # CMN
    nv = torch.as_tensor(n_valid_samples, device=dev).long()
    nvf = ((nv - frame_len).div(hop, rounding_mode="floor") + 1).clamp_min(1)[..., None, None]
    valid = torch.arange(n_frames, device=dev)[:, None] < nvf
    mean = torch.where(valid, mel, 0.0).sum(dim=-2, keepdim=True) / nvf.to(mel.dtype)
    return torch.where(valid, mel - mean, 0.0)                 # CMN over valid rows


def prepare_frames(mel: np.ndarray, target: int) -> np.ndarray:
    """Tile short / center-crop long to ``target`` frames
    (CamPlusPlusSpeaker.swift:108-133)."""
    n = len(mel)
    if n >= target:
        off = (n - target) // 2
        return mel[off: off + target]
    reps = int(np.ceil(target / n))
    return np.tile(mel, (reps, 1))[:target]


# ---------------------------------------------------------------------------
# network (NCL / NCHW activations, the reference's torch weight layouts)
# ---------------------------------------------------------------------------

def _bn(x: torch.Tensor, p, axis: int = -1) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    inv = torch.rsqrt(p["var"] + 1e-5)
    y = (x - p["mean"].reshape(shape)) * inv.reshape(shape)
    if "scale" in p:
        y = y * p["scale"].reshape(shape) + p["bias"].reshape(shape)
    return y


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride=(1, 1), padding=(1, 1)) -> torch.Tensor:
    """NCHW conv, torch OIHW weights (taken in the port's HWIO layout)."""
    return conv2d_nchw(x, {"kernel": w.permute(2, 3, 1, 0)}, stride=stride, padding=padding)


def _conv1d(x: torch.Tensor, p, stride: int = 1, dilation: int = 1,
            padding: int = 0) -> torch.Tensor:
    """NCL conv, torch [out, in, k] weights, optional bias "b"."""
    q = {"kernel": p["w"].permute(2, 1, 0)}
    if "b" in p:
        q["bias"] = p["b"]
    return conv1d(x.transpose(1, 2), q, stride=stride, padding=padding,
                  dilation=dilation).transpose(1, 2)


def _res_block(x, p, stride):
    h = torch.relu(_bn(_conv2d(x, p["conv1"], (stride, 1)), p["bn1"], axis=1))
    h = _bn(_conv2d(h, p["conv2"]), p["bn2"], axis=1)
    if "shortcut_w" in p:
        x = _bn(_conv2d(x, p["shortcut_w"], (stride, 1), (0, 0)), p["shortcut_bn"], axis=1)
    return torch.relu(h + x)


def _fcm(p, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, F] → [B, C·F/8, T] (T unchanged; freq strided 2·2·2)."""
    x = mel.transpose(1, 2)[:, None]                       # [B,1,F,T]
    x = torch.relu(_bn(_conv2d(x, p["conv1"]), p["bn1"], axis=1))
    for i, blk in enumerate(p["layer1"]):
        x = _res_block(x, blk, 2 if i == 0 else 1)
    for i, blk in enumerate(p["layer2"]):
        x = _res_block(x, blk, 2 if i == 0 else 1)
    x = torch.relu(_bn(_conv2d(x, p["conv2"], (2, 1)), p["bn2"], axis=1))
    b, c, f, t = x.shape
    return x.reshape(b, c * f, t)


def _bn_relu(x, p):
    return torch.relu(_bn(x, p, axis=1))


def _seg_pool(x: torch.Tensor, seg_len: int) -> torch.Tensor:
    """avg_pool1d(kernel=seg, stride=seg, ceil_mode) then nearest-repeat
    back to T (CAMLayer.seg_pooling)."""
    b, c, t = x.shape
    n_seg = -(-t // seg_len)
    xp = torch.nn.functional.pad(x, (0, n_seg * seg_len - t))
    seg = xp.reshape(b, c, n_seg, seg_len)
    counts = torch.clamp(t - torch.arange(n_seg, device=x.device) * seg_len, max=seg_len)
    means = seg.sum(-1) / counts.to(x.dtype)
    return means.repeat_interleave(seg_len, dim=-1)[..., :t]


def _cam_layer(x, p, cfg: CampPlusConfig, dilation: int):
    pad = (cfg.kernel_size - 1) // 2 * dilation
    y = _conv1d(x, p["linear_local"], dilation=dilation, padding=pad)
    context = x.mean(-1, keepdim=True) + _seg_pool(x, cfg.seg_len)
    context = torch.relu(_conv1d(context, p["linear1"]))
    m = torch.sigmoid(_conv1d(context, p["linear2"]))
    return y * m


def _dense_layer(x, p, cfg: CampPlusConfig, dilation: int):
    h = _bn_relu(x, p["nonlinear1"])
    h = _conv1d(h, {"w": p["linear1"]})
    h = _bn_relu(h, p["nonlinear2"])
    return _cam_layer(h, p["cam"], cfg, dilation)


def campplus_forward(params, cfg: CampPlusConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, feat_dim] (CMN'd) → embeddings [B, embedding_size]."""
    x = _fcm(params["head"], mel)
    x = _conv1d(x, params["tdnn"]["linear"], stride=2, padding=2)
    x = _bn_relu(x, params["tdnn"]["nonlinear"])
    for bi, _ in enumerate(cfg.block_layers):
        dil = cfg.block_dilations[bi]
        for layer in params["blocks"][bi]:
            x = torch.cat([x, _dense_layer(x, layer, cfg, dil)], dim=1)
        tr = params["transits"][bi]
        x = _conv1d(_bn_relu(x, tr["nonlinear"]), {"w": tr["linear"]})
    x = _bn_relu(x, params["out_nonlinear"])
    mean = x.mean(-1)
    std = torch.sqrt(torch.clamp(x.var(-1, unbiased=False), min=1e-8))
    stats = torch.cat([mean, std], dim=1)                  # [B, 2C]
    emb = _conv1d(stats[..., None], params["dense"]["linear"])[..., 0]
    return _bn(emb, params["dense"]["nonlinear"], axis=1)  # affine-free bn


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _draw_params(cfg: CampPlusConfig, normal, zeros, ones) -> dict:
    def conv2(o, i, k=3):
        return normal((o, i, k, k), 1.0 / np.sqrt(i * k * k))

    def bn(c, affine=True):
        p = {"mean": zeros(c), "var": ones(c)}
        if affine:
            p["scale"] = ones(c)
            p["bias"] = zeros(c)
        return p

    def conv1(o, i, k=1, bias=False):
        p = {"w": normal((o, i, k), 1.0 / np.sqrt(i * k))}
        if bias:
            p["b"] = zeros(o)
        return p

    m = cfg.m_channels

    def res(first):
        p = {"conv1": conv2(m, m), "bn1": bn(m), "conv2": conv2(m, m), "bn2": bn(m)}
        if first:
            p["shortcut_w"] = conv2(m, m, 1)
            p["shortcut_bn"] = bn(m)
        return p

    head = {"conv1": conv2(m, 1), "bn1": bn(m),
            "layer1": [res(True), res(False)], "layer2": [res(True), res(False)],
            "conv2": conv2(m, m), "bn2": bn(m)}
    channels = cfg.init_channels
    bn_ch = cfg.bn_size * cfg.growth_rate
    blocks, transits = [], []
    for n_layers in cfg.block_layers:
        block = []
        for _ in range(n_layers):
            block.append({
                "nonlinear1": bn(channels),
                "linear1": conv1(bn_ch, channels)["w"],
                "nonlinear2": bn(bn_ch),
                "cam": {"linear_local": conv1(cfg.growth_rate, bn_ch, cfg.kernel_size),
                        "linear1": conv1(bn_ch // 2, bn_ch, bias=True),
                        "linear2": conv1(cfg.growth_rate, bn_ch // 2, bias=True)},
            })
            channels += cfg.growth_rate
        blocks.append(block)
        transits.append({"nonlinear": bn(channels), "linear": conv1(channels // 2, channels)["w"]})
        channels //= 2
    return {
        "head": head,
        "tdnn": {"linear": conv1(cfg.init_channels, cfg.head_out, 5, bias=True),
                 "nonlinear": bn(cfg.init_channels)},
        "blocks": blocks,
        "transits": transits,
        "out_nonlinear": bn(channels),
        "dense": {"linear": conv1(cfg.embedding_size, channels * 2, bias=True),
                  "nonlinear": bn(cfg.embedding_size, affine=False)},
    }


def init_campplus_params(rng: np.random.Generator, cfg: CampPlusConfig) -> dict:
    """Random weights drawn with numpy, in the reference's tree."""
    return _draw_params(
        cfg, lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda n: np.zeros((n,), np.float32), lambda n: np.ones((n,), np.float32))


def init_campplus_params_on_device(cfg: CampPlusConfig, generator: torch.Generator) -> dict:
    """The same tree drawn on the generator's device."""
    dev = generator.device
    return _draw_params(
        cfg, lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda n: torch.zeros((n,), device=dev), lambda n: torch.ones((n,), device=dev))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class CampPlusSpeaker(SpeakerEmbeddingModel):
    """192-d CAM++ speaker embeddings on one device (the card unless the
    caller asks for the CPU); not L2-normalised — the CosyVoice flow
    normalises internally."""

    FBANK_BUCKETS_S = (2, 5, 10, 20, 30)

    def __init__(self, cfg: CampPlusConfig, params, dtype: torch.dtype = torch.float32, *,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        self._loaded = True

    @classmethod
    def init_random(cls, cfg: Optional[CampPlusConfig] = None, seed: int = 0, *,
                    device="cuda", **kw) -> "CampPlusSpeaker":
        """Random weights (``config_tiny()`` by default, as the reference)
        drawn from a ``torch.Generator`` seeded ``seed`` on the host."""
        cfg = cfg or config_tiny()
        return cls(cfg, init_campplus_params_on_device(cfg, torch.Generator().manual_seed(seed)),
                   device=device, **kw)

    @classmethod
    def init_random_on_device(cls, cfg: Optional[CampPlusConfig] = None, seed: int = 0, *,
                              device="cuda", **kw) -> "CampPlusSpeaker":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``."""
        cfg = cfg or CONFIG_CAMPPLUS
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_campplus_params_on_device(cfg, generator), device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "aufklarer/CamPlusPlus-Speaker-CoreML",
                        cache_dir=None, offline_mode: bool = False, **kw):
        """A checkpoint from a directory, a cached snapshot or a fetch (``core/hub.py``)."""
        from ...core.hub import download_weights
        from .campplus_convert import convert_checkpoint

        model_dir = download_weights(model_id, cache_dir=cache_dir,
                                     offline_mode=offline_mode)
        cfg, params = convert_checkpoint(model_dir)
        return cls(cfg, params, **kw)

    @property
    def embedding_dim(self) -> int:
        return self.cfg.embedding_size

    def _clip(self, audio, sample_rate: int) -> np.ndarray:
        from ...audio.resample import resample

        audio = np.asarray(audio, np.float32)
        if sample_rate != self.cfg.sample_rate:
            audio = resample(audio, sample_rate, self.cfg.sample_rate)
        if len(audio) < 1600:
            raise ValueError(
                f"Audio too short for speaker embedding ({len(audio)} samples, need >= 1600)")
        return audio

    @torch.inference_mode()
    def _mels(self, clips) -> list:
        """Clips → their CMN'd mels over their valid frames (numpy), from one
        batched fbank over the clips padded to a shared bucket."""
        frame_len, hop = 400, 160
        longest = max(len(a) for a in clips)
        bucket = next((s * self.cfg.sample_rate for s in self.FBANK_BUCKETS_S
                       if longest <= s * self.cfg.sample_rate), longest)
        stage = np.zeros((len(clips), max(bucket, longest)), np.float32)
        n_real = np.zeros(len(clips), np.int64)
        for i, a in enumerate(clips):
            stage[i, : len(a)] = a
            n_real[i] = len(a)
        mels = campplus_fbank(torch.from_numpy(stage).to(self.device), n_real,
                              self.cfg).cpu().numpy()
        out = []
        for i in range(len(clips)):
            mel = mels[i][: max(1 + (int(n_real[i]) - frame_len) // hop, 0)]
            if len(mel) < 10:
                raise ValueError(f"Too few mel frames ({len(mel)}, need >= 10)")
            out.append(prepare_frames(mel, self.cfg.target_frames))
        return out

    @torch.inference_mode()
    def forward_frames(self, mels: np.ndarray) -> np.ndarray:
        """Prepared mels [N, target_frames, feat_dim] → embeddings [N, E]."""
        x = torch.from_numpy(np.ascontiguousarray(mels, np.float32)).to(self.device, self.dtype)
        return campplus_forward(self.params, self.cfg, x).float().cpu().numpy()

    def embed(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        mel = self._mels([self._clip(audio, sample_rate)])[0]
        return self.forward_frames(mel[None])[0]

    def embed_batch(self, audios, sample_rate: int = 16000) -> np.ndarray:
        """Embed N clips with one batched fbank over a shared bucket and one
        batched D-TDNN forward. Row for row :meth:`embed`'s function;
        returns [N, embedding_size]."""
        if not len(audios):
            return np.zeros((0, self.cfg.embedding_size), np.float32)
        clips = [self._clip(a, sample_rate) for a in audios]
        return self.forward_frames(np.stack(self._mels(clips)))

    def warm_up(self):
        self.embed(np.zeros(self.cfg.sample_rate, np.float32))

    def unload(self):
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self):
        return self._loaded
