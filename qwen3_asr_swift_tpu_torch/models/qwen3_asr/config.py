"""Qwen3-ASR configuration — the frozen dataclasses and presets of
``qwen3_asr_swift_tpu/models/qwen3_asr/config.py`` and its
``detect_config``, copied because that package's
``models/qwen3_asr/__init__.py`` imports jax.

The field names, defaults and presets must stay equal to the reference's;
``tests/test_torch_config.py`` compares them field by field.
"""

from __future__ import annotations

import dataclasses

from ...core.config import detect_bits, detect_size


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    d_model: int = 896
    num_heads: int = 14
    ffn_dim: int = 3584
    num_layers: int = 18
    n_mels: int = 128
    output_dim: int = 1024
    downsample_hidden: int = 480
    n_window: int = 50          # chunk = 2*n_window = 100 mel frames
    n_window_infer: int = 800   # attention window = 800 mel frames = 104 tokens
    layer_norm_eps: float = 1e-5
    conv_out_input_dim: int = 7680  # 480 channels * 16 mel positions

    @property
    def chunk_frames(self) -> int:
        return 2 * self.n_window  # 100

    @property
    def tokens_per_chunk(self) -> int:
        # three stride-2 convs: 100 → 50 → 25 → 13
        f = self.chunk_frames
        for _ in range(3):
            f = (f - 1) // 2 + 1
        return f

    @property
    def chunks_per_window(self) -> int:
        return self.n_window_infer // self.chunk_frames  # 8

    @property
    def window_tokens(self) -> int:
        return self.tokens_per_chunk * self.chunks_per_window  # 104

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclasses.dataclass(frozen=True)
class TextDecoderConfig:
    vocab_size: int = 151936
    hidden_size: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    tie_word_embeddings: bool = True
    # quantization of the source checkpoint
    group_size: int = 64
    bits: int = 4


@dataclasses.dataclass(frozen=True)
class Qwen3ASRConfig:
    encoder: AudioEncoderConfig = AudioEncoderConfig()
    decoder: TextDecoderConfig = TextDecoderConfig()
    # special tokens
    audio_pad_id: int = 151676
    audio_start_id: int = 151669
    audio_end_id: int = 151670
    eos_id: int = 151645            # <|im_end|>
    pad_id: int = 151643            # <|endoftext|>
    im_start_id: int = 151644
    asr_text_id: int = 151704
    timestamp_id: int = 151705
    # plain-text role tokens
    system_id: int = 8948
    user_id: int = 872
    assistant_id: int = 77091
    newline_id: int = 198
    # forced aligner head
    classify_num: int = 5000
    timestamp_segment_time: float = 0.08


ENCODER_SMALL = AudioEncoderConfig()  # 0.6B: d=896, 14 heads, 18 layers
ENCODER_LARGE = AudioEncoderConfig(
    d_model=1024, num_heads=16, ffn_dim=4096, num_layers=24, output_dim=2048
)
ENCODER_ALIGNER = AudioEncoderConfig(
    d_model=1024, num_heads=16, ffn_dim=4096, num_layers=24, output_dim=1024
)

DECODER_SMALL = TextDecoderConfig()  # 0.6B: hidden 1024, inter 3072
DECODER_LARGE = TextDecoderConfig(hidden_size=2048, intermediate_size=6144)

CONFIG_SMALL = Qwen3ASRConfig(encoder=ENCODER_SMALL, decoder=DECODER_SMALL)
CONFIG_LARGE = Qwen3ASRConfig(encoder=ENCODER_LARGE, decoder=DECODER_LARGE)


def config_tiny(vocab_size: int = 512) -> Qwen3ASRConfig:
    """Small random-weight config for CPU unit tests."""
    return Qwen3ASRConfig(
        encoder=AudioEncoderConfig(
            d_model=64, num_heads=4, ffn_dim=128, num_layers=2, output_dim=48,
            downsample_hidden=24, conv_out_input_dim=24 * 16,
        ),
        decoder=TextDecoderConfig(
            vocab_size=vocab_size, hidden_size=48, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=96,
        ),
        # keep special ids inside the tiny vocab
        audio_pad_id=vocab_size - 10, audio_start_id=vocab_size - 9,
        audio_end_id=vocab_size - 8, eos_id=vocab_size - 7, pad_id=vocab_size - 6,
        im_start_id=vocab_size - 5, asr_text_id=vocab_size - 4,
        timestamp_id=vocab_size - 3, system_id=1, user_id=2, assistant_id=3,
        newline_id=4,
    )


def detect_config(model_id: str) -> Qwen3ASRConfig:
    """Sniff size and quantization bits from a HF model id
    (reference: ASRModelSize.detect/detectBits, Qwen3ASR.swift:581-601)."""
    cfg = detect_size(model_id, {"1.7b": CONFIG_LARGE}, CONFIG_SMALL)
    bits = detect_bits(model_id, default=4 if cfg is CONFIG_SMALL else 8)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, bits=bits))
