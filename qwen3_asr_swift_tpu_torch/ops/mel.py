"""Log-mel over a fixed frame budget — port of
``qwen3_asr_swift_tpu/ops/mel.py::log_mel_kernel``.

A frame gather, the windowed DFT as two matmuls (cos and sin), the power
spectrum, a mel matmul, then log10 / max-clamp / normalize over the valid
frames only. The constant matrices come from the reference's jax-free
numpy builders (``mel_filterbank``, ``windowed_dft``) and are cached per
device. Batched over clips.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from qwen3_asr_swift_tpu.ops.mel import MelConfig, mel_filterbank, windowed_dft

_consts_lock = threading.Lock()
_consts: dict = {}


def _constants(cfg: MelConfig, device: torch.device):
    key = (cfg, str(device))
    with _consts_lock:
        if key not in _consts:
            cos_m, sin_m = windowed_dft(cfg.n_fft, cfg.padded_fft)
            fb = mel_filterbank(cfg.n_mels, cfg.n_freqs, cfg.sample_rate, cfg.padded_fft)
            _consts[key] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                 for a in (cos_m, sin_m, fb))
        return _consts[key]


def log_mel_kernel(padded_audio: torch.Tensor, n_valid_frames: torch.Tensor,
                   cfg: MelConfig, total_frames: int) -> torch.Tensor:
    """padded_audio fp32 [B, (total_frames-1)*hop + n_fft] (already
    reflect-padded and zero-extended); n_valid_frames int [B] →
    fp32 [B, n_mels, total_frames] (padding frames zeroed)."""
    dev = padded_audio.device
    cos_m, sin_m, fb = _constants(cfg, dev)
    idx = (torch.arange(total_frames, device=dev)[:, None] * cfg.hop_length
           + torch.arange(cfg.n_fft, device=dev)[None, :])
    frames = padded_audio.float()[:, idx]                    # [B, frames, n_fft]
    re = frames @ cos_m
    im = frames @ sin_m
    mel = (re * re + im * im) @ fb                           # [B, frames, n_mels]
    log_spec = torch.log10(torch.clamp(mel, min=cfg.log_clamp_floor))
    valid = torch.arange(total_frames, device=dev)[None, :] < n_valid_frames.to(dev)[:, None]
    masked = torch.where(valid[..., None], log_spec, torch.full_like(log_spec, -float("inf")))
    global_max = masked.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, global_max - cfg.dynamic_range)
    log_spec = (log_spec + 4.0) / 4.0
    log_spec = torch.where(valid[..., None], log_spec, torch.zeros_like(log_spec))
    return log_spec.transpose(1, 2)
