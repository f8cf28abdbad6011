"""Cache-aware streaming conformer configs.

TPU-native analog of the reference's ParakeetStreamingASR / Nemotron
configuration (reference:
Sources/ParakeetStreamingASR/Configuration.swift:8-53 — EOU 120M: 17
layers d=512, attention context 70, conv cache 8, pre-encode mel cache,
33-mel-frame chunks → 4 encoder frames, RNNT vocab 1024 + <EOU> + blank;
Sources/NemotronStreamingASR/* — same pattern at 0.6B, English with
native punctuation).

Chunk geometry here is exact-causal: the three stride-2 k=3 VALID convs
have a combined receptive field of 15 and stride 8, so a chunk of
``mel_frames`` (multiple of 8) plus a 7-frame pre-cache yields exactly
``mel_frames/8`` new encoder frames with no overlap or gap — the
loopback pre-cache replaces the reference's CoreML overlap bookkeeping
(StreamingSession.swift:141-165).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StreamingConformerConfig:
    # mel frontend (NeMo-style, shared with batch Parakeet)
    num_mel_bins: int = 128
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    pre_emphasis: float = 0.97
    log_zero_guard: float = 2.0 ** -24
    # streaming geometry
    mel_frames: int = 32           # mel frames consumed per chunk (multiple of 8)
    pre_cache: int = 7             # mel left-context carried between chunks
    # encoder
    encoder_hidden: int = 512
    encoder_layers: int = 17
    num_heads: int = 8
    ffn_expansion: int = 4
    conv_kernel: int = 9           # depthwise kernel; conv cache = kernel - 1
    att_context: int = 70          # left attention context (cached keys)
    subsampling_channels: int = 256
    # prediction network (LSTM)
    decoder_hidden: int = 640
    decoder_layers: int = 1
    # joint
    joint_hidden: int = 640
    vocab_size: int = 1025         # text pieces + <EOU>
    eou_token_id: int = 1024
    blank_token_id: int = 1025     # == vocab_size (last joint logit)
    max_symbols_per_frame: int = 5

    @property
    def head_dim(self) -> int:
        return self.encoder_hidden // self.num_heads

    @property
    def out_frames(self) -> int:
        return self.mel_frames // 8

    @property
    def conv_cache(self) -> int:
        return self.conv_kernel - 1

    @property
    def samples_per_chunk(self) -> int:
        return self.mel_frames * self.hop_length


# EOU 120M (reference: Configuration.swift:35-53, adapted to exact-causal
# chunking: 32 mel frames/chunk instead of 33-with-overlap)
CONFIG_EOU_120M = StreamingConformerConfig()

# Nemotron streaming 0.6B (reference: Sources/NemotronStreamingASR — same
# cache-aware architecture, English, larger encoder + punctuation vocab)
CONFIG_NEMOTRON_06B = StreamingConformerConfig(
    encoder_hidden=1024,
    encoder_layers=24,
    vocab_size=1025,
)


def config_tiny() -> StreamingConformerConfig:
    return StreamingConformerConfig(
        num_mel_bins=32, mel_frames=16, encoder_hidden=32, encoder_layers=2,
        num_heads=2, ffn_expansion=2, att_context=6, subsampling_channels=8,
        decoder_hidden=16, decoder_layers=1, joint_hidden=16,
        vocab_size=29, eou_token_id=28, blank_token_id=29,
    )
