"""WeSpeaker ResNet34 speaker embedding — port of
``qwen3_asr_swift_tpu/models/speaker/model.py``.

80-mel Kaldi fbank of ``audio · 32768`` (mean-normalised over the valid
frames) → ResNet34 (2-d convs over [time, mel], channels 32/64/128/256,
blocks 3/4/6/3) → statistics pooling over the valid output frames (mean ‖
std per channel × mel) → linear → 256-d embedding, L2-normalised.

The convs are the port's NHWC ``ops/nn.py::conv2d`` (fp32 sums of tap
matmuls). The padding bucket is part of the function: every clip is padded
to a ``FBANK_BUCKETS_S`` bucket, and past the first conv the padded rows
are no longer zero, so the convs at the last valid rows read them. The
port pads to the reference's bucket, and ``embed_batch`` puts every clip
in the largest clip's bucket, as the reference's ``vmap`` does; the batch
is one forward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...core.params import params_from_jax
from ...core.protocols import SpeakerEmbeddingModel
from ...device import resolve_device
from ...ops.fbank import kaldi_fbank
from ...ops.nn import conv2d


def _draw_params(normal, zeros, ones, embed_dim: int, channels, blocks, n_mels: int) -> dict:
    def conv(kh, kw, cin, cout):
        return {"kernel": normal((kh, kw, cin, cout), 1.0 / np.sqrt(kh * kw * cin))}

    def bn(c):
        return {"scale": ones(c), "bias": zeros(c)}

    params = {"stem": {"conv": conv(3, 3, 1, channels[0]), "bn": bn(channels[0])}, "stages": []}
    cin = channels[0]
    for si, (c, nb) in enumerate(zip(channels, blocks)):
        stage = []
        for bi in range(nb):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk = {"conv1": conv(3, 3, cin, c), "bn1": bn(c), "conv2": conv(3, 3, c, c),
                   "bn2": bn(c)}
            if stride != 1 or cin != c:
                blk["down"] = conv(1, 1, cin, c)
                blk["down_bn"] = bn(c)
            stage.append(blk)
            cin = c
        params["stages"].append(stage)
    pool_dim = channels[-1] * (n_mels // 8) * 2  # three stride-2 stages; mean ‖ std
    params["embed"] = {"kernel": normal((pool_dim, embed_dim), 1.0 / np.sqrt(pool_dim)),
                       "bias": zeros(embed_dim)}
    return params


def init_wespeaker_params(rng: np.random.Generator, embed_dim: int = 256,
                          channels=(32, 64, 128, 256), blocks=(3, 4, 6, 3),
                          n_mels: int = 80) -> dict:
    """Random weights drawn with numpy at the published widths by default,
    in the reference's tree."""
    return _draw_params(
        lambda shape, scale: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        lambda n: np.zeros((n,), np.float32), lambda n: np.ones((n,), np.float32),
        embed_dim, channels, blocks, n_mels)


def init_wespeaker_params_on_device(generator: torch.Generator, embed_dim: int = 256,
                                    channels=(32, 64, 128, 256), blocks=(3, 4, 6, 3),
                                    n_mels: int = 80) -> dict:
    """The same tree drawn on the generator's device."""
    dev = generator.device
    return _draw_params(
        lambda shape, scale: torch.randn(shape, generator=generator, device=dev) * scale,
        lambda n: torch.zeros((n,), device=dev), lambda n: torch.ones((n,), device=dev),
        embed_dim, channels, blocks, n_mels)


def _bn(x, p):
    return x * p["scale"] + p["bias"]


def _basic_block(x, p, stride):
    h = torch.relu(_bn(conv2d(x, p["conv1"], stride=(stride, stride)), p["bn1"]))
    h = _bn(conv2d(h, p["conv2"], stride=(1, 1)), p["bn2"])
    if "down" in p:
        x = _bn(conv2d(x, p["down"], stride=(stride, stride), padding=((0, 0), (0, 0))),
                p["down_bn"])
    return torch.relu(x + h)


def wespeaker_forward(params, fbank: torch.Tensor, n_valid_frames: torch.Tensor) -> torch.Tensor:
    """fbank [B, T, n_mels] (padded), n_valid_frames [B] integers →
    embeddings [B, embed_dim] (not normalised)."""
    b, t, _ = fbank.shape
    nv = n_valid_frames.to(fbank.device)
    valid = (torch.arange(t, device=fbank.device)[None, :] < nv[:, None])[..., None]
    # cepstral mean normalisation over the valid frames
    cnt = nv.clamp_min(1).to(fbank.dtype)[:, None, None]
    mean = torch.where(valid, fbank, 0.0).sum(dim=1, keepdim=True) / cnt
    x = torch.where(valid, fbank - mean, 0.0)

    h = x[..., None]                                             # [B, T, mel, 1]
    h = torch.relu(_bn(conv2d(h, params["stem"]["conv"], stride=(1, 1)), params["stem"]["bn"]))
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            h = _basic_block(h, blk, stride=2 if (bi == 0 and si > 0) else 1)
    # statistics pooling over the valid output frames: the valid length
    # follows the convs' own length transform (k 3, s 2, p 1 → (n-1)//2 + 1,
    # three stride-2 stages)
    t_out = h.shape[1]
    for _ in range(3):
        nv = torch.div(nv - 1, 2, rounding_mode="floor") + 1
    valid_out = torch.arange(t_out, device=h.device)[None, :] < nv.clamp_min(1)[:, None]
    m = valid_out[:, :, None, None]
    cnt = valid_out.sum(dim=1).clamp_min(1).to(h.dtype)[:, None, None]
    mu = torch.where(m, h, 0.0).sum(dim=1) / cnt                   # [B, mel', C]
    var = torch.where(m, (h - mu[:, None]) ** 2, 0.0).sum(dim=1) / cnt
    sd = torch.sqrt(var + 1e-7)
    pooled = torch.cat([mu.reshape(b, -1), sd.reshape(b, -1)], dim=-1)
    return pooled @ params["embed"]["kernel"] + params["embed"]["bias"]


class WeSpeaker(SpeakerEmbeddingModel):
    """WeSpeaker ResNet34 on one device (the card unless the caller asks
    for the CPU). ``params`` is a tree in the reference's layout."""

    FBANK_BUCKETS_S = (2, 5, 10, 20, 30)

    def __init__(self, params, dtype: torch.dtype = torch.float32, *, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = params_from_jax(params, self.device, dtype)
        self._loaded = True

    @classmethod
    def init_random(cls, seed: int = 0, *, device="cuda", **kw) -> "WeSpeaker":
        """Random weights at the published widths, drawn from a
        ``torch.Generator`` seeded ``seed`` on the host."""
        return cls(init_wespeaker_params_on_device(torch.Generator().manual_seed(seed)),
                   device=device, **kw)

    @classmethod
    def init_random_on_device(cls, seed: int = 0, *, device="cuda", **kw) -> "WeSpeaker":
        """Random weights drawn on ``device`` from a seeded ``torch.Generator``."""
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return cls(init_wespeaker_params_on_device(generator), device=dev, **kw)

    @classmethod
    def from_pretrained(cls, model_id: str = "wespeaker-resnet34", cache_dir=None,
                        offline_mode: bool = False, progress_handler=None, **kw) -> "WeSpeaker":
        """A checkpoint from a directory, a cached snapshot or a fetch (``core/hub.py``)."""
        from ...core.hub import download_weights
        from ...core.weights import load_safetensors
        from .convert import convert_wespeaker

        model_dir = download_weights(model_id, cache_dir=cache_dir, offline_mode=offline_mode)
        return cls(convert_wespeaker(load_safetensors(model_dir)), **kw)

    @property
    def embed_dim(self) -> int:
        return int(self.params["embed"]["kernel"].shape[1])

    def bucket_samples(self, n: int) -> int:
        """The padded length of a clip of ``n`` samples at 16 kHz."""
        return next((s * 16000 for s in self.FBANK_BUCKETS_S if n <= s * 16000),
                    self.FBANK_BUCKETS_S[-1] * 16000)

    @torch.inference_mode()
    def embed_raw(self, stage: np.ndarray, n_valid: np.ndarray) -> torch.Tensor:
        """Clips [N, bucket] zero-padded to one bucket, their valid sample
        counts [N] → unnormalised embeddings [N, embed_dim] on the device."""
        audio = torch.from_numpy(np.ascontiguousarray(stage, np.float32)).to(self.device)
        fb = kaldi_fbank(audio * 32768.0).to(self.dtype)
        n_valid = torch.as_tensor(np.asarray(n_valid, np.int64))
        frames = (n_valid - 400).div(160, rounding_mode="floor").add(1).clamp_min(1)
        return wespeaker_forward(self.params, fb, frames.to(self.device)).float()

    def embed(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        if sample_rate != 16000:
            from ...audio.resample import resample

            audio = resample(audio.astype(np.float32), sample_rate, 16000)
        n = len(audio)
        bucket = self.bucket_samples(n)
        padded = np.zeros((1, bucket), np.float32)
        padded[0, : min(n, bucket)] = audio[:bucket]
        emb = self.embed_raw(padded, np.asarray([min(n, bucket)]))[0].cpu().numpy()
        return emb / (np.linalg.norm(emb) + 1e-12)

    def embed_batch(self, audios: Sequence[np.ndarray], sample_rate: int = 16000) -> np.ndarray:
        """Embed N clips in one batched forward (all clips share the
        largest needed bucket). Row for row equal to :meth:`embed` where a
        clip's own bucket is the largest; returns [N, embed_dim]
        L2-normalised."""
        if not len(audios):
            return np.zeros((0, self.embed_dim), np.float32)
        from ...audio.resample import resample

        clips = []
        for a in audios:
            a = np.asarray(a, np.float32)
            if sample_rate != 16000:
                a = resample(a, sample_rate, 16000)
            clips.append(a)
        bucket = self.bucket_samples(max(len(a) for a in clips))
        stage = np.zeros((len(clips), bucket), np.float32)
        n_valid = np.zeros(len(clips), np.int64)
        for i, a in enumerate(clips):
            n = min(len(a), bucket)
            stage[i, :n] = a[:n]
            n_valid[i] = n
        embs = self.embed_raw(stage, n_valid).cpu().numpy()
        return embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-12)

    def warm_up(self) -> None:
        self.embed(np.zeros(16000, np.float32))

    def unload(self) -> None:
        self.params = None
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded
