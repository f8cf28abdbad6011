"""Parakeet-TDT configuration (reference: Sources/ParakeetASR/Configuration.swift:4-72)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ParakeetConfig:
    # mel frontend (NeMo-style)
    num_mel_bins: int = 128
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    pre_emphasis: float = 0.97
    log_zero_guard: float = 2.0 ** -24
    # FastConformer encoder
    encoder_hidden: int = 1024
    encoder_layers: int = 24
    num_heads: int = 8
    ffn_expansion: int = 4
    conv_kernel: int = 9
    subsampling_factor: int = 8
    subsampling_channels: int = 256
    # prediction network
    decoder_hidden: int = 640
    decoder_layers: int = 2
    # joint
    joint_hidden: int = 640
    vocab_size: int = 8192
    blank_token_id: int = 8192
    num_duration_bins: int = 5
    duration_bins: Tuple[int, ...] = (0, 1, 2, 3, 4)
    first_text_token_id: int = 274  # 0..273 are control/lang/speaker tags

    @property
    def head_dim(self) -> int:
        return self.encoder_hidden // self.num_heads


CONFIG_06B = ParakeetConfig()


def config_tiny(vocab_size: int = 64) -> ParakeetConfig:
    return ParakeetConfig(
        num_mel_bins=32,
        encoder_hidden=32,
        encoder_layers=2,
        num_heads=2,
        conv_kernel=5,
        subsampling_channels=8,
        decoder_hidden=16,
        decoder_layers=2,
        joint_hidden=16,
        vocab_size=vocab_size,
        blank_token_id=vocab_size,
        first_text_token_id=4,
    )
