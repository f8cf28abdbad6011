"""Qwen3-TTS configuration — the port's copy of
``qwen3_asr_swift_tpu/models/qwen3_tts/config.py`` (reference:
Sources/Qwen3TTS/Configuration.swift)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    hidden_size: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, ...] = (24, 20, 20)
    rms_norm_eps: float = 1e-6
    text_vocab_size: int = 151936
    text_hidden_size: int = 2048
    codec_vocab_size: int = 3072
    # text-vocab special ids (reference: Configuration.swift:152-194 —
    # Qwen chat-template ids plus the TTS pad/bos/eos text tokens). Config
    # fields, not constants, so reduced-vocab configs stay in range:
    # jnp.take fills out-of-vocab gathers with NaN, which silently poisons
    # the whole prompt (same convention as qwen3_asr/config.py:81-89).
    im_start_id: int = 151644
    im_end_id: int = 151645
    nl_id: int = 198
    assistant_id: int = 77091
    user_id: int = 872
    tts_pad_id: int = 151671
    tts_bos_id: int = 151672
    tts_eos_id: int = 151673


@dataclasses.dataclass(frozen=True)
class CodePredictorConfig:
    hidden_size: int = 1024
    embedding_dim: int = 1024  # 2048 with projection in 1.7B
    num_layers: int = 5
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    vocab_size: int = 2048
    num_code_groups: int = 16

    @property
    def needs_projection(self) -> bool:
        return self.embedding_dim != self.hidden_size


@dataclasses.dataclass(frozen=True)
class CodecDecoderConfig:
    latent_dim: int = 1024
    decoder_dim: int = 1536
    hidden_size: int = 512
    num_heads: int = 16
    head_dim: int = 64
    num_layers: int = 8
    upsample_rates: Tuple[int, ...] = (8, 5, 4, 3)
    upsampling_ratios: Tuple[int, ...] = (2, 2)
    num_quantizers: int = 16
    semantic_codebook_size: int = 2048
    acoustic_codebook_size: int = 2048
    codebook_dim: int = 256
    sample_rate: int = 24000
    frame_rate: float = 12.5
    rms_norm_eps: float = 1e-8

    @property
    def samples_per_frame(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        for r in self.upsampling_ratios:
            out *= r
        return out  # 1920


@dataclasses.dataclass(frozen=True)
class Qwen3TTSConfig:
    talker: TalkerConfig = TalkerConfig()
    code_predictor: CodePredictorConfig = CodePredictorConfig()
    codec: CodecDecoderConfig = CodecDecoderConfig()


class CodecTokens:
    """Special codec + TTS-text tokens (reference: Configuration.swift:152-194)."""

    PAD = 2148
    BOS = 2149
    EOS = 2150
    THINK = 2154
    NOTHINK = 2155
    THINK_BOS = 2156
    THINK_EOS = 2157
    TTS_PAD = 151671
    TTS_BOS = 151672
    TTS_EOS = 151673

    LANGUAGES: Dict[str, int] = {
        "english": 2050, "en": 2050,
        "german": 2052, "de": 2052,
        "chinese": 2055, "zh": 2055,
        "japanese": 2058, "ja": 2058,
        "spanish": 2054, "es": 2054,
        "french": 2061, "fr": 2061,
        "korean": 2064, "ko": 2064,
        "russian": 2069, "ru": 2069,
        "italian": 2070, "it": 2070,
        "portuguese": 2071, "pt": 2071,
        "beijing_dialect": 2074,
        "sichuan_dialect": 2062,
    }

    @classmethod
    def language_id(cls, language: str) -> Optional[int]:
        return cls.LANGUAGES.get(language.lower())


CONFIG_06B = Qwen3TTSConfig()
CONFIG_17B = Qwen3TTSConfig(
    talker=TalkerConfig(hidden_size=2048, intermediate_size=6144, text_hidden_size=2048),
    code_predictor=CodePredictorConfig(embedding_dim=2048),
)


def config_tiny() -> Qwen3TTSConfig:
    return Qwen3TTSConfig(
        talker=TalkerConfig(
            hidden_size=48, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            intermediate_size=96, mrope_sections=(4, 2, 2), text_vocab_size=512,
            text_hidden_size=64, codec_vocab_size=3072,
            # remap the text-vocab special ids inside the tiny vocab
            im_start_id=500, im_end_id=501, nl_id=198, assistant_id=502,
            user_id=503, tts_pad_id=504, tts_bos_id=505, tts_eos_id=506,
        ),
        code_predictor=CodePredictorConfig(
            hidden_size=48, embedding_dim=48, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=96, vocab_size=2048, num_code_groups=16,
        ),
        codec=CodecDecoderConfig(
            latent_dim=32, decoder_dim=32, hidden_size=16, num_heads=2, head_dim=8,
            num_layers=1, upsample_rates=(8, 5, 4, 3), upsampling_ratios=(2, 2),
            codebook_dim=8,
        ),
    )
