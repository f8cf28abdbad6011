"""The port's own copies of the JAX package's jax-free host code.

The port imports nothing of ``qwen3_asr_swift_tpu``; it carries copies of
what it needs. Each copy is held here against its original on seeded
numpy inputs, with exact equality (the copies are the same numpy code),
and one AST walk shows that no module of the port, nor ``chip_smoke.py``,
imports the JAX package.
"""

import ast
import dataclasses
import importlib
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from qwen3_asr_swift_tpu.audio import companding as j_comp
from qwen3_asr_swift_tpu.audio import io as j_io
from qwen3_asr_swift_tpu.core import config as j_config
from qwen3_asr_swift_tpu.core import protocols as j_protocols
from qwen3_asr_swift_tpu.core import types as j_types
from qwen3_asr_swift_tpu.core import weights as j_weights
from qwen3_asr_swift_tpu.models.qwen3_asr import aligner as j_aligner
from qwen3_asr_swift_tpu.models.qwen3_asr import config as j_asr_config
from qwen3_asr_swift_tpu.models.qwen3_asr import convert as j_convert
from qwen3_asr_swift_tpu.models.qwen3_asr import streaming as j_streaming
from qwen3_asr_swift_tpu.models.silero_vad import model as j_vad
from qwen3_asr_swift_tpu.models.qwen3_tts import config as j_tts_config
from qwen3_asr_swift_tpu.models.qwen3_tts import convert as j_tts_convert
from qwen3_asr_swift_tpu.models.qwen3_tts import model as j_tts_model
from qwen3_asr_swift_tpu.models.qwen3_tts import voice_clone as j_voice_clone
from qwen3_asr_swift_tpu.models.enhancement import convert as j_dfn_convert
from qwen3_asr_swift_tpu.models.enhancement import dfn3 as j_dfn3
from qwen3_asr_swift_tpu.models.enhancement import model as j_enh_model
from qwen3_asr_swift_tpu.models.personaplex import convert as j_pp_convert
from qwen3_asr_swift_tpu.models.personaplex import mimi as j_mimi
from qwen3_asr_swift_tpu.models.personaplex import model as j_pp_model
from qwen3_asr_swift_tpu.serving import server as j_server
from qwen3_asr_swift_tpu.serving import ws as j_ws
from qwen3_asr_swift_tpu.tokenizers import sentencepiece_model as j_spm
from qwen3_asr_swift_tpu.models.silero_vad import streaming as j_vad_stream
from qwen3_asr_swift_tpu.ops import fbank as j_fbank
from qwen3_asr_swift_tpu.ops import mel as j_mel
from qwen3_asr_swift_tpu.serving import batching as j_batching
from qwen3_asr_swift_tpu.serving import dispatch as j_dispatch
from qwen3_asr_swift_tpu.tokenizers import bpe as j_bpe
from qwen3_asr_swift_tpu.core import logging as j_logging
from qwen3_asr_swift_tpu.models.chat import convert as j_chat_convert
from qwen3_asr_swift_tpu.models.chat import model as j_chat
from qwen3_asr_swift_tpu.pipeline import engine as j_engine
from qwen3_asr_swift_tpu.core import text_chunker as j_chunker
from qwen3_asr_swift_tpu.models.cosyvoice import convert as j_cosy_convert
from qwen3_asr_swift_tpu.models.cosyvoice import dit as j_cosy_dit
from qwen3_asr_swift_tpu.models.cosyvoice import hift as j_cosy_hift
from qwen3_asr_swift_tpu.models.cosyvoice import model as j_cosy
from qwen3_asr_swift_tpu.models.vibevoice import convert as j_vibe_convert
from qwen3_asr_swift_tpu.models.vibevoice import diffusion as j_vibe_diff
from qwen3_asr_swift_tpu.models.vibevoice import model as j_vibe
from qwen3_asr_swift_tpu.models.vibevoice import tokenizer as j_vibe_tok
from qwen3_asr_swift_tpu.audio import ringbuffer as j_ring
from qwen3_asr_swift_tpu.core import loader as j_loader
from qwen3_asr_swift_tpu.models.kokoro import model as j_kokoro
from qwen3_asr_swift_tpu.models.voxcpm2 import model as j_vox
from qwen3_asr_swift_tpu.ui import store as j_store
from qwen3_asr_swift_tpu.models.pyannote import model as j_pyannote
from qwen3_asr_swift_tpu.models.firered_vad import model as j_firered
from qwen3_asr_swift_tpu.models.speaker import campplus as j_campplus
from qwen3_asr_swift_tpu.models.separation import model as j_separation
from qwen3_asr_swift_tpu.models.translation import model as j_translation
from qwen3_asr_swift_tpu.models.diarization import sortformer as j_sortformer
from qwen3_asr_swift_tpu.models.omnilingual import model as j_omni
from qwen3_asr_swift_tpu.models.parakeet import encoder as j_pk_enc
from qwen3_asr_swift_tpu.models.parakeet import mel as j_pk_mel
from qwen3_asr_swift_tpu.models.parakeet import model as j_pk
from qwen3_asr_swift_tpu.models.parakeet_streaming import encoder as j_pks_enc
from qwen3_asr_swift_tpu.models.parakeet_streaming import model as j_pks
from qwen3_asr_swift_tpu.models.wakeword import model as j_wake
from qwen3_asr_swift_tpu.models.wakeword import zipformer as j_zip
from qwen3_asr_swift_tpu.core import hub as j_hub
from qwen3_asr_swift_tpu.models.qwen3_asr import encoder as j_asr_enc
from qwen3_asr_swift_tpu.ops import attention as j_att
from qwen3_asr_swift_tpu.ops import kv_cache as j_kv
from qwen3_asr_swift_tpu.ops import quant as j_quant
from qwen3_asr_swift_tpu.ops import rope as j_rope
from qwen3_asr_swift_tpu_torch.audio import companding as p_comp
from qwen3_asr_swift_tpu_torch.audio import io as p_io
from qwen3_asr_swift_tpu_torch.core import config as p_config
from qwen3_asr_swift_tpu_torch.core import protocols as p_protocols
from qwen3_asr_swift_tpu_torch.core import types as p_types
from qwen3_asr_swift_tpu_torch.core import weights as p_weights
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import aligner as p_aligner
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import config as p_asr_config
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import convert as p_convert
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import streaming as p_streaming
from qwen3_asr_swift_tpu_torch.models.silero_vad import model as p_vad
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import config as p_tts_config
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import convert as p_tts_convert
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import model as p_tts_model
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import voice_clone as p_voice_clone
from qwen3_asr_swift_tpu_torch.models.enhancement import convert as p_dfn_convert
from qwen3_asr_swift_tpu_torch.models.enhancement import dfn3 as p_dfn3
from qwen3_asr_swift_tpu_torch.models.enhancement import model as p_enh_model
from qwen3_asr_swift_tpu_torch.models.personaplex import convert as p_pp_convert
from qwen3_asr_swift_tpu_torch.models.personaplex import mimi as p_mimi
from qwen3_asr_swift_tpu_torch.models.personaplex import model as p_pp_model
from qwen3_asr_swift_tpu_torch.serving import server as p_server
from qwen3_asr_swift_tpu_torch.serving import ws as p_ws
from qwen3_asr_swift_tpu_torch.tokenizers import sentencepiece_model as p_spm
from qwen3_asr_swift_tpu_torch.models.silero_vad import streaming as p_vad_stream
from qwen3_asr_swift_tpu_torch.ops import fbank as p_fbank
from qwen3_asr_swift_tpu_torch.ops import mel as p_mel
from qwen3_asr_swift_tpu_torch.serving import batching as p_batching
from qwen3_asr_swift_tpu_torch.serving import dispatch as p_dispatch
from qwen3_asr_swift_tpu_torch.tokenizers import bpe as p_bpe
from qwen3_asr_swift_tpu_torch.core import logging as p_logging
from qwen3_asr_swift_tpu_torch.models.chat import convert as p_chat_convert
from qwen3_asr_swift_tpu_torch.models.chat import model as p_chat
from qwen3_asr_swift_tpu_torch.core import text_chunker as p_chunker
from qwen3_asr_swift_tpu_torch.models.cosyvoice import convert as p_cosy_convert
from qwen3_asr_swift_tpu_torch.models.cosyvoice import dit as p_cosy_dit
from qwen3_asr_swift_tpu_torch.models.cosyvoice import hift as p_cosy_hift
from qwen3_asr_swift_tpu_torch.models.cosyvoice import model as p_cosy
from qwen3_asr_swift_tpu_torch.models.vibevoice import convert as p_vibe_convert
from qwen3_asr_swift_tpu_torch.models.vibevoice import diffusion as p_vibe_diff
from qwen3_asr_swift_tpu_torch.models.vibevoice import model as p_vibe
from qwen3_asr_swift_tpu_torch.models.vibevoice import tokenizer as p_vibe_tok
from qwen3_asr_swift_tpu_torch.pipeline import engine as p_engine
from qwen3_asr_swift_tpu_torch.audio import ringbuffer as p_ring
from qwen3_asr_swift_tpu_torch.core import loader as p_loader
from qwen3_asr_swift_tpu_torch.models.kokoro import model as p_kokoro
from qwen3_asr_swift_tpu_torch.models.voxcpm2 import model as p_vox
from qwen3_asr_swift_tpu_torch.ui import store as p_store
from qwen3_asr_swift_tpu_torch.models.pyannote import model as p_pyannote
from qwen3_asr_swift_tpu_torch.models.firered_vad import model as p_firered
from qwen3_asr_swift_tpu_torch.models.speaker import campplus as p_campplus
from qwen3_asr_swift_tpu_torch.models.separation import model as p_separation
from qwen3_asr_swift_tpu_torch.models.translation import model as p_translation
from qwen3_asr_swift_tpu_torch.models.diarization import sortformer as p_sortformer
from qwen3_asr_swift_tpu_torch.models.omnilingual import model as p_omni
from qwen3_asr_swift_tpu_torch.models.parakeet import encoder as p_pk_enc
from qwen3_asr_swift_tpu_torch.models.parakeet import mel as p_pk_mel
from qwen3_asr_swift_tpu_torch.models.parakeet import model as p_pk
from qwen3_asr_swift_tpu_torch.models.parakeet_streaming import encoder as p_pks_enc
from qwen3_asr_swift_tpu_torch.models.parakeet_streaming import model as p_pks
from qwen3_asr_swift_tpu_torch.models.wakeword import model as p_wake
from qwen3_asr_swift_tpu_torch.models.wakeword import zipformer as p_zip
from qwen3_asr_swift_tpu_torch.core import hub as p_hub
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import encoder as p_asr_enc
from qwen3_asr_swift_tpu_torch.ops import attention as p_att
from qwen3_asr_swift_tpu_torch.ops import kv_cache as p_kv
from qwen3_asr_swift_tpu_torch.ops import quant as p_quant
from qwen3_asr_swift_tpu_torch.ops import rope as p_rope

# the audio packages export the function ``resample`` over the module's name
j_resample = importlib.import_module("qwen3_asr_swift_tpu.audio.resample")
p_resample = importlib.import_module("qwen3_asr_swift_tpu_torch.audio.resample")

REPO = Path(__file__).resolve().parent.parent
# the encoders' size threshold from which both packages take their native
# C++ codec (the numpy-path check below turns it off in both)
NATIVE_MIN = 65536


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_mlx_matches(bits):
    w = np.random.default_rng(bits).standard_normal((48, 256)).astype(np.float32)
    for got, want in zip(p_weights.quantize_mlx(w, bits, 64), j_weights.quantize_mlx(w, bits, 64)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [(), (80, 201, 16000, 400), (128, 257, 16000, 512, 20.0, 7600.0)])
def test_mel_filterbank_matches(args):
    np.testing.assert_array_equal(p_mel.mel_filterbank(*args), j_mel.mel_filterbank(*args))


@pytest.mark.parametrize("args", [(), (256, 256)])
def test_windowed_dft_matches(args):
    for got, want in zip(p_mel.windowed_dft(*args), j_mel.windowed_dft(*args)):
        np.testing.assert_array_equal(got, want)


def test_mel_config_num_frames_and_reflect_pad_match():
    pc, jc = p_mel.MelConfig(), j_mel.MelConfig()
    assert [getattr(pc, f) for f in pc.__dataclass_fields__] == \
        [getattr(jc, f) for f in jc.__dataclass_fields__]
    assert pc.n_freqs == jc.n_freqs
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 5, 199, 200, 201, 16000, 16001, 12_000_000 + 7):
        assert p_mel.num_frames(pc, n) == j_mel.num_frames(jc, n), n
    for n in (2, 3, 150, 201, 4000):
        audio = rng.standard_normal((2, n)).astype(np.float32)
        np.testing.assert_array_equal(p_mel.reflect_pad_np(audio, 200),
                                      j_mel.reflect_pad_np(audio, 200))


@pytest.mark.parametrize("name", ["mulaw_encode_np", "pcm4_encode_np", "dpcm4_encode_np"])
@pytest.mark.parametrize("n", [2048, 2 * NATIVE_MIN + 256])
def test_wire_encoders_match_numpy_path(monkeypatch, name, n):
    """Below and above the native threshold: the port's numpy path is the
    JAX package's numpy path, bit for bit (the native codecs are held
    against it by tests/test_companding.py and tests/test_torch_wire_codec.py)."""
    monkeypatch.setattr(j_comp, "_native_lib", False)
    monkeypatch.setattr(p_comp, "_native_lib", False)
    x = (0.3 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    x[0, :4] = [1.5, -1.5, 0.0, 1e-9]
    got, want = getattr(p_comp, name)(x), getattr(j_comp, name)(x)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    assert p_comp.MU == j_comp.MU and p_comp.PCM4_BLOCK == j_comp.PCM4_BLOCK


@pytest.mark.parametrize("rates", [(8000, 16000), (44100, 16000), (16000, 16000), (22050, 24000)])
def test_resample_matches(rates):
    x = np.random.default_rng(1).standard_normal(4410).astype(np.float32)
    np.testing.assert_array_equal(p_resample.resample(x, *rates), j_resample.resample(x, *rates))


def test_resample_rejects_bad_rates():
    with pytest.raises(ValueError):
        p_resample.resample(np.zeros(4, np.float32), 0, 16000)


def test_wav_round_trip_matches(tmp_path):
    rng = np.random.default_rng(2)
    x = np.clip(0.4 * rng.standard_normal(3001), -1.2, 1.2).astype(np.float32)
    body = p_io.wav_bytes(x, 22050)
    assert body == j_io.wav_bytes(x, 22050)
    (got, rate), (want, want_rate) = p_io.read_wav(body), j_io.read_wav(body)
    assert rate == want_rate == 22050
    np.testing.assert_array_equal(got, want)
    path = tmp_path / "x.wav"
    p_io.write_wav(path, x, 8000)
    np.testing.assert_array_equal(p_io.load_audio(path, 16000)[0], j_io.load_audio(path, 16000)[0])
    for bad in (b"", b"RIFF" + bytes(40), body[:20] + b"\xff" * 30):
        with pytest.raises(p_io.WAVError):
            p_io.read_wav(bad)


def test_sample_conversions_match():
    rng = np.random.default_rng(3)
    for x in (rng.integers(-32768, 32767, 64, dtype=np.int16),
              rng.integers(0, 255, 64, dtype=np.uint8), rng.standard_normal(64)):
        np.testing.assert_array_equal(p_types.to_float32(x), j_types.to_float32(x))
    y = 1.5 * rng.standard_normal(64).astype(np.float32)
    np.testing.assert_array_equal(p_types.to_pcm16(y), j_types.to_pcm16(y))


def _toy_vocab():
    enc = j_bpe._bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256)}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"), ("Ġ", "w"), ("Ġw", "o")]
    for i, (a, b) in enumerate(merges):
        vocab[a + b] = 256 + i
    return vocab, merges, {"<|im_start|>": 400, "<|im_end|>": 401}


@pytest.mark.parametrize("text", ["hello world", "<|im_start|>hello<|im_end|> wo 123",
                                  "héllo, 世界! 4567", ""])
def test_bpe_tokenizer_matches(text):
    vocab, merges, special = _toy_vocab()
    port, ref = p_bpe.BPETokenizer(vocab, merges, special), j_bpe.BPETokenizer(vocab, merges, special)
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.encode(text, allow_special=False) == ref.encode(text, allow_special=False)
    assert port.decode(ids) == ref.decode(ids) and port.decode(ids) == text
    assert port.decode(ids, skip_special=True) == ref.decode(ids, skip_special=True)
    assert port.vocab_size == ref.vocab_size


@pytest.mark.parametrize("port,ref,names", [
    (p_dispatch, j_dispatch, ["DispatchGate", "set_thread_nice", "thread_nice", "gate_slot"]),
    (p_batching, j_batching, ["ContinuousBatcher"]),
    (p_io, j_io, ["read_wav", "wav_bytes", "load_audio"]),
    (p_bpe, j_bpe, ["BPETokenizer"]),
    (p_comp, j_comp, ["mulaw_encode_np", "pcm4_encode_np", "dpcm4_encode_np"]),
    (p_types, j_types, ["AudioChunk", "PartialTranscription", "SpeechSegment", "AlignedWord"]),
    (p_protocols, j_protocols, ["VoiceActivityDetectionModel", "StreamingVADProvider",
                                "ForcedAlignmentModel"]),
    (p_config, j_config, ["detect_size", "detect_bits"]),
    (p_weights, j_weights, ["dequantize_mlx"]),
    (p_convert, j_convert, ["_conv_to_hwio", "_linear", "_ln", "_rms", "strip_prefixes",
                            "convert_encoder", "convert_decoder"]),
    (p_asr_config, j_asr_config, ["detect_config"]),
    (p_vad_stream, j_vad_stream, ["VADEventType", "VADEvent", "_State",
                                  "StreamingVADProcessor"]),
    (p_vad, j_vad, ["VADConfig", "dft_basis", "convert_checkpoint", "convert_torchscript",
                    "binarize"]),
    (p_streaming, j_streaming, ["longest_common_prefix", "StreamingASRConfig", "StreamingASR"]),
    (p_aligner, j_aligner, ["split_word_pairs", "SlottedText", "slot_text", "lis_positions",
                            "enforce_monotonicity"]),
    (p_batching, j_batching, ["_TTSRequest", "TTSBatcher"]),
    (p_protocols, j_protocols, ["SpeechGenerationModel"]),
    (p_tts_config, j_tts_config, ["TalkerConfig", "CodePredictorConfig", "CodecDecoderConfig",
                                  "Qwen3TTSConfig", "CodecTokens", "config_tiny"]),
    (p_tts_convert, j_tts_convert, ["detect_tts_config", "load_speaker_config", "_Loader",
                                    "_decoder_layers", "_rvq_codebook", "convert_tts_checkpoint",
                                    "_snake_from", "_convnext_from"]),
    (p_tts_model, j_tts_model, ["TTSSamplingConfig", "_round_up"]),
    (p_voice_clone, j_voice_clone, ["_factor_strides", "ReferenceAudioCache"]),
    (p_fbank, j_fbank, ["hz_to_mel_htk", "mel_to_hz_htk", "kaldi_mel_banks", "_povey_dft"]),
    (p_ws, j_ws, ["accept_key", "encode_frame", "_unmask", "read_frame", "read_message",
                  "WebSocket", "encode_client_frame", "SyncWSClient"]),
    (p_server, j_server, ["RealtimeSession"]),
    (p_protocols, j_protocols, ["SpeechToSpeechModel", "SpeechEnhancementModel"]),
    (p_spm, j_spm, ["_read_varint", "_skip_field", "SentencePieceModel"]),
    (p_dfn_convert, j_dfn_convert, ["_load_state_dict", "_index_groups", "_conv_block",
                                    "_gru_stack", "map_dfn3_state_dict", "convert_checkpoint"]),
    (p_enh_model, j_enh_model, ["vorbis_window", "_dft", "_idft", "_erb_fb_widths",
                                "erb_filterbank", "erb_inverse_filterbank",
                                "default_mean_norm_init", "default_unit_norm_init"]),
    (p_pp_convert, j_pp_convert, ["_t", "_conv", "_convT", "_transformer_layers",
                                  "_seanet_encoder", "_seanet_decoder", "_rvq",
                                  "dequantize_state_dict", "_rope_traditional_to_half",
                                  "convert_moshi_tree", "export_moshi_state_dict",
                                  "normalize_mimi_keys", "convert_mimi_tree"]),
    (p_mimi, j_mimi, ["MimiConfig", "config_tiny", "_causal_pad"]),
    (p_pp_model, j_pp_model, ["PersonaPlexConfig", "config_tiny", "PersonaSampling"]),
    (p_bpe, j_bpe, ["StreamingDecoder"]),
    (p_protocols, j_protocols, ["PipelineLLM"]),
    (p_logging, j_logging, ["get_logger", "log_stage"]),
    (p_chat, j_chat, ["ChatConfig", "ChatSamplingConfig", "config_tiny"]),
    (p_chat_convert, j_chat_convert, ["convert_chat_checkpoint"]),
    (p_engine, j_engine, ["_CEvent", "_CCallbacks", "_CConfig", "PipelineState",
                          "PipelineEventType", "PipelineEvent", "PipelineConfig", "tool_call"]),
    (p_chunker, j_chunker, ["chunk_text", "_joiner", "_flush"]),
    (p_weights, j_weights, ["unflatten", "relist", "fuse_weight_norm", "flatten"]),
    (p_cosy_convert, j_cosy_convert, ["_strip_prefixes", "_Keys", "convert_llm", "convert_flow",
                                      "convert_hift", "convert_checkpoint", "load_or_convert",
                                      "_tree_from_flat", "save_converted"]),
    (p_cosy, j_cosy, ["CosyVoiceConfig", "config_tiny", "parse_dialogue", "Voice"]),
    (p_cosy_dit, j_cosy_dit, ["CosyDiTConfig", "CosyFlowConfig", "flow_config_tiny"]),
    (p_cosy_hift, j_cosy_hift, ["CosyHiFTConfig", "hift_config_tiny"]),
    (p_vibe_convert, j_vibe_convert, ["_Keys", "_qwen2_layer", "_connector",
                                      "convert_diffusion_head", "_tokenizer_block",
                                      "convert_tokenizer_side", "convert_checkpoint"]),
    (p_vibe_diff, j_vibe_diff, ["DiffusionConfig", "diffusion_config_tiny", "_alphas_cumprod",
                                "solver_coefficients"]),
    (p_vibe_tok, j_vibe_tok, ["TokenizerConfig", "tokenizer_config_tiny"]),
    (p_vibe, j_vibe, ["VibeVoiceConfig", "config_tiny"]),
    (p_kokoro, j_kokoro, ["KokoroConfig", "config_tiny", "trim_and_fade"]),
    (p_vox, j_vox, ["ModDims", "VoxCPM2Config", "config_tiny", "cfm_time_span"]),
    (p_loader, j_loader, ["ModelSpec", "ModelSet", "ModelLoader", "MemoryTier"]),
    (p_protocols, j_protocols, ["StreamingRecognitionModel", "SpeakerEmbeddingModel",
                                "SpeakerDiarizationModel", "SourceSeparationModel",
                                "WakeWordModel", "TranslationModel"]),
    (p_types, j_types, ["DiarizedSegment"]),
    (p_pyannote, j_pyannote, ["SegmentationConfig", "config_tiny", "binarize"]),
    (p_firered, j_firered, ["FireRedVADConfig", "config_tiny"]),
    (p_campplus, j_campplus, ["CampPlusConfig", "config_tiny", "_campplus_dft",
                              "_htk_mel_banks", "prepare_frames"]),
    (p_separation, j_separation, ["_dft", "signal_to_distortion_ratio"]),
    (p_translation, j_translation, ["T5Config", "config_tiny"]),
    (p_zip, j_zip, ["ZipformerConfig", "decoder_out", "joiner_logits"]),
    (p_pk_mel, j_pk_mel, ["nemo_windowed_dft", "nemo_num_frames", "prepare_nemo_audio",
                          "nemo_log_mel_reference"]),
    (p_pk_enc, j_pk_enc, ["rel_pos_encoding"]),
    (p_pks_enc, j_pks_enc, ["_rel_table"]),
    (p_pks, j_pks, ["StreamingResult"]),
    (p_sortformer, j_sortformer, ["SortformerConfig", "config_tiny"]),
    (p_omni, j_omni, ["OmniConfig", "config_tiny", "conv_output_length", "ctc_greedy_collapse"]),
    (p_hub, j_hub, ["sanitized_cache_key", "validated_remote_file_name", "get_cache_directory",
                    "_have_local_snapshot", "download_weights"]),
    (p_comp, j_comp, ["mulaw_decode_np", "pcm4_decode_np"]),
    (p_config, j_config, ["from_json_file", "from_dict"]),
    (p_weights, j_weights, ["maybe_dequantize_linear"]),
    (p_mel, j_mel, ["log_mel_reference"]),
    (p_att, j_att, ["sdpa_reference"]),
    (p_rope, j_rope, ["rope_reference"]),
    (p_quant, j_quant, ["is_quantized"]),
    (p_asr_enc, j_asr_enc, ["conv_output_length"]),
])
def test_copied_code_is_the_original(port, ref, names):
    """Whole copies keep their originals' source, so a fix to one shows as
    a difference here. Lines the port adds to a copy end in
    ``# port: queue wait`` and are left out of the comparison; the copy
    must otherwise be the original, line for line."""
    for name in names:
        got, want = inspect.getsource(getattr(port, name)), inspect.getsource(getattr(ref, name))
        assert without_port_lines(got) == want, name


def without_port_lines(source: str) -> str:
    return "".join(line for line in source.splitlines(keepends=True)
                   if not line.rstrip().endswith(PORT_LINE))


PORT_LINE = "# port: queue wait"


def test_port_lines_are_marked_only_in_the_batchers():
    """The marker that the comparison above skips appears only in the
    batchers' copy, where the port adds ``mean_queue_wait_ms``."""
    marked = {str(f.relative_to(REPO)) for f in (REPO / "qwen3_asr_swift_tpu_torch").rglob("*.py")
              if PORT_LINE in f.read_text()}
    assert marked == {"qwen3_asr_swift_tpu_torch/serving/batching.py"}


@pytest.mark.parametrize("port,ref,names", [
    (p_server.SpeechServer, j_server.SpeechServer,
     ["_handle_respond", "_handle_enhance", "_handle_websocket"]),
    (p_pp_model.PersonaPlex, j_pp_model.PersonaPlex,
     ["available_voices", "voice", "_build_voice_ring", "load_voice_prompt",
      "_silence_spacer_frames", "_prompt_tokens", "_prompt_reads"]),
    (p_engine.VoicePipeline, j_engine.VoicePipeline,
     ["_malloc_str", "_handle_event", "start", "stop", "push_audio", "push_text",
      "resume_listening", "add_tool", "clear_tools", "state", "is_running", "drain_events",
      "close", "__enter__", "__exit__"]),
    (p_chat.Qwen3Chat, j_chat.Qwen3Chat, ["apply_chat_template"]),
    (p_vibe.VibeVoiceTTS, j_vibe.VibeVoiceTTS, ["_load_voice", "_enc", "_build_prompt"]),
    (p_cosy.CosyVoiceTTS, j_cosy.CosyVoiceTTS, ["register_voice", "_encode_text",
                                                "synthesize", "synthesize_stream",
                                                "synthesize_dialogue"]),
    (p_kokoro.KokoroTTS, j_kokoro.KokoroTTS, ["available_voices", "_ref_s", "warm_up",
                                              "is_loaded"]),
    (p_vox.VoxCPM2TTS, j_vox.VoxCPM2TTS, ["warm_up", "unload", "is_loaded"]),
    (p_pyannote.PyannoteSegmentation, j_pyannote.PyannoteSegmentation,
     ["frames_per_window", "frame_duration", "unload", "is_loaded"]),
    (p_pyannote.PyannoteVAD, j_pyannote.PyannoteVAD,
     ["__init__", "detect_speech", "speech_probabilities", "warm_up", "unload", "is_loaded"]),
    (p_firered.FireRedVAD, j_firered.FireRedVAD,
     ["detect_speech", "speech_probabilities", "warm_up", "unload", "is_loaded"]),
    (p_campplus.CampPlusSpeaker, j_campplus.CampPlusSpeaker,
     ["embedding_dim", "warm_up", "unload", "is_loaded"]),
    (p_separation.SourceSeparator, j_separation.SourceSeparator, ["warm_up", "is_loaded"]),
    (p_translation.MADLADTranslator, j_translation.MADLADTranslator,
     ["translate", "translate_stream"]),
    (p_wake.WakeWordDetector, j_wake.WakeWordDetector,
     ["detect", "new_session", "num_params", "warm_up", "unload", "is_loaded"]),
    (p_wake.WakeWordSession, j_wake.WakeWordSession, ["push"]),
    (p_pk.ParakeetASR, j_pk.ParakeetASR,
     ["_bucket_samples", "transcribe", "warm_up", "unload", "is_loaded"]),
    (p_sortformer.SortformerDiarizer, j_sortformer.SortformerDiarizer,
     ["reset_state", "_update_state", "_push_spkcache", "_binarize", "unload", "is_loaded"]),
    (p_pks.StreamingSession, j_pks.StreamingSession,
     ["push_audio", "finalize", "force_end_of_utterance", "_confidence"]),
    (p_pks.ParakeetStreamingASR, j_pks.ParakeetStreamingASR,
     ["new_session", "decode_tokens", "transcribe", "transcribe_stream", "warm_up", "unload",
      "is_loaded"]),
    (p_omni.OmnilingualASR, j_omni.OmnilingualASR, ["warm_up", "unload", "is_loaded"]),
    (p_kv.KVCache, j_kv.KVCache, ["max_len", "batch"]),
    (p_mel.MelFrontend, j_mel.MelFrontend, ["_bucket_for", "padded_len_for_frames"]),
])
def test_copied_methods_are_the_originals(port, ref, names):
    for name in names:
        got, want = inspect.getattr_static(port, name), inspect.getattr_static(ref, name)
        if isinstance(got, property):
            got, want = got.fget, want.fget
        if isinstance(got, staticmethod):
            got, want = got.__func__, want.__func__
        assert inspect.getsource(got) == inspect.getsource(want), name
    for name in ("VOICE_PROMPT_CAP", "DELAY_RING", "PROMPT_CAP", "VOICES"):
        assert getattr(port, name, None) == getattr(ref, name, None), name


def test_personaplex_and_dfn3_constants_match():
    for name in ("SINE_TOKENS", "SILENCE_TOKENS", "DEFAULT_SYSTEM_PROMPT_TOKENS"):
        assert getattr(p_pp_model, name) == getattr(j_pp_model, name), name
    assert dataclasses.asdict(p_pp_model.CONFIG_7B) == dataclasses.asdict(j_pp_model.CONFIG_7B)
    assert (dataclasses.asdict(p_pp_model.config_tiny())
            == dataclasses.asdict(j_pp_model.config_tiny()))
    assert p_pp_model.CONFIG_7B.mimi.samples_per_frame == 1920
    for name in ("NB_ERB", "NB_DF", "DF_ORDER", "CONV_CH", "EMB_HIDDEN", "EMB_DIM", "DF_HIDDEN",
                 "ENC_LIN_GROUPS", "LIN_GROUPS", "LOOKAHEAD", "DF_PATHWAY_KT", "LSNR_MIN",
                 "LSNR_MAX"):
        assert getattr(p_dfn3, name) == getattr(j_dfn3, name), name
    for name in ("SR", "N_FFT", "HOP", "N_BINS", "NORM_ALPHA"):
        assert getattr(p_enh_model, name) == getattr(j_enh_model, name), name


def _sp_model(path):
    def varint(v):
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def piece(text, score, kind):
        body = b"\x0a" + varint(len(text.encode())) + text.encode()
        body += b"\x15" + np.float32(score).tobytes() + b"\x18" + varint(kind)
        return b"\x0a" + varint(len(body)) + body

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("\u2581hello", -1.0, 1),
              ("\u2581world", -1.5, 1), ("ing", -2.0, 1), ("\u2581", -2.5, 1),
              ("<0xE4>", -3.0, 6), ("<0xB8>", -3.0, 6), ("<0xAD>", -3.0, 6)]
    path.write_bytes(b"".join(piece(*p) for p in pieces))
    return path


@pytest.mark.parametrize("text", ["hello world", "helloing world", "中", ""])
def test_sentencepiece_matches(tmp_path, text):
    path = _sp_model(tmp_path / "sp.model")
    port, ref = p_spm.SentencePieceModel.load(path), j_spm.SentencePieceModel.load(path)
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.decode(ids) == ref.decode(ids)


def test_tts_configs_and_codec_tokens_match():
    for name in ("CONFIG_06B", "CONFIG_17B"):
        assert (dataclasses.asdict(getattr(p_tts_config, name))
                == dataclasses.asdict(getattr(j_tts_config, name))), name
    assert dataclasses.asdict(p_tts_config.config_tiny()) == dataclasses.asdict(
        j_tts_config.config_tiny())
    port, ref = p_tts_config.CONFIG_17B, j_tts_config.CONFIG_17B
    assert port.codec.samples_per_frame == ref.codec.samples_per_frame == 1920
    assert port.code_predictor.needs_projection and ref.code_predictor.needs_projection
    tokens = {k: v for k, v in vars(j_tts_config.CodecTokens).items() if not k.startswith("_")
              and not callable(v) and not isinstance(v, classmethod)}
    assert {k: getattr(p_tts_config.CodecTokens, k) for k in tokens} == tokens
    for lang in ("english", "ZH", "sichuan_dialect", "klingon"):
        assert (p_tts_config.CodecTokens.language_id(lang)
                == j_tts_config.CodecTokens.language_id(lang))


@pytest.mark.parametrize("args", [(80, 512, 16000), (64, 512, 16000, 40.0, -200.0),
                                  (23, 256, 8000)])
def test_fbank_constants_match(args):
    np.testing.assert_array_equal(p_fbank.kaldi_mel_banks(*args), j_fbank.kaldi_mel_banks(*args))
    n_fft = args[1]
    for got, want in zip(p_fbank._povey_dft(400, n_fft), j_fbank._povey_dft(400, n_fft)):
        np.testing.assert_array_equal(got, want)
    hz = np.linspace(0, 8000, 17)
    np.testing.assert_array_equal(p_fbank.hz_to_mel_htk(hz), j_fbank.hz_to_mel_htk(hz))
    np.testing.assert_array_equal(p_fbank.mel_to_hz_htk(hz), j_fbank.mel_to_hz_htk(hz))


def test_tts_paths_import_nothing_of_the_jax_package():
    """Running the CLI (``denoise``, ``respond``, ``kokoro`` and ``voxcpm2``
    too), ``Qwen3TTS``, both
    TTS batchers (the group ``TTSBatcher`` and ``SlotPoolTTS``),
    ``SpeechEnhancer``, ``PersonaPlex`` and a ``/v1/realtime`` session
    imports neither jax nor any module of the JAX package."""
    code = textwrap.dedent("""
        import contextlib, io, os, sys, tempfile
        import numpy as np, torch
        from qwen3_asr_swift_tpu_torch import cli
        from qwen3_asr_swift_tpu_torch.audio.io import write_wav
        from qwen3_asr_swift_tpu_torch.models.qwen3_tts import (Qwen3TTS, TTSSamplingConfig,
                                                                config_tiny)
        from qwen3_asr_swift_tpu_torch.serving import SlotPoolTTS, TTSBatcher
        s = TTSSamplingConfig(temperature=0.0, max_frames=3)
        m = Qwen3TTS.init_random(config_tiny(), 0, device="cpu", dtype=torch.float32,
                                 tokenizer=cli.byte_tokenizer())
        assert len(m.synthesize("hi", sampling=s).samples) > 0
        b = TTSBatcher(m, workers=1)
        assert b.synthesize("hi", sampling=s).sample_rate == 24000
        b.shutdown()
        pool = SlotPoolTTS(m, slots=2, sampling=s)
        assert len(pool.synthesize("hi").samples) > 0
        pool.close()
        from qwen3_asr_swift_tpu_torch.models.enhancement import SpeechEnhancer
        from qwen3_asr_swift_tpu_torch.models.personaplex import (PersonaPlex, PersonaSampling,
                                                                  config_tiny as pp_tiny)
        from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny as asr_tiny
        from qwen3_asr_swift_tpu_torch.serving import SpeechServer, build_registry
        from qwen3_asr_swift_tpu_torch.serving.ws import SyncWSClient
        import asyncio, base64, threading
        enh = SpeechEnhancer.init_random(0, device="cpu")
        assert len(enh.enhance(np.zeros(4800, np.float32), 48000).samples) == 4800
        pp = PersonaPlex.init_random(pp_tiny(), 0, device="cpu")
        assert len(pp.respond(np.zeros(1920, np.float32), 24000,
                              sampling=PersonaSampling(max_steps=2)).samples) > 0
        asr = Qwen3ASR.init_random(asr_tiny(), device="cpu", dtype=torch.float32,
                                   audio_buckets_s=(8,))
        asr.max_tokens = 2
        m.sampling = s
        server = SpeechServer(build_registry(asr, m), port=0)
        loop = asyncio.new_event_loop()
        t = threading.Thread(target=loop.run_forever, daemon=True)
        t.start()
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=30)
        ws = SyncWSClient("127.0.0.1", server._server.sockets[0].getsockname()[1])
        assert ws.recv_json()["type"] == "session.created"
        ws.send_json({"type": "input_audio_buffer.append",
                      "audio": base64.b64encode(np.zeros(1600, "<i2").tobytes()).decode()})
        ws.send_json({"type": "input_audio_buffer.commit"})
        ws.send_json({"type": "response.create", "response": {"instructions": "hi"}})
        seen = []
        while not seen or seen[-1] != "response.done":
            seen.append(ws.recv_json()["type"])
        assert "conversation.item.input_audio_transcription.completed" in seen, seen
        assert "response.audio.delta" in seen, seen
        ws.close()
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=30)
        with tempfile.TemporaryDirectory() as d:
            clip = os.path.join(d, "clip.wav")
            write_wav(clip, np.zeros(16000, np.float32), 16000)
            with contextlib.redirect_stdout(io.StringIO()):
                for argv in (["transcribe", clip, "--max-tokens", "2"],
                             ["transcribe-batch", clip, "--max-tokens", "2"],
                             ["align", clip, "one"], ["vad", clip], ["vad-stream", clip],
                             ["speak", "hi", "--output", os.path.join(d, "o.wav")],
                             ["denoise", clip, "--output", os.path.join(d, "d.wav")],
                             ["respond", clip, "--output", os.path.join(d, "r.wav")],
                             ["kokoro", "hi", "--output", os.path.join(d, "k.wav")],
                             ["voxcpm2", "hi", "--output", os.path.join(d, "x.wav")]):
                    cli.main(["--device", "cpu", argv[0], "--random-weights", *argv[1:]])
        assert "jax" not in sys.modules, [k for k in sys.modules if k.startswith("jax")]
        ref = [k for k in sys.modules
               if k == "qwen3_asr_swift_tpu" or k.startswith("qwen3_asr_swift_tpu.")]
        assert not ref, ref
        print("OK")
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def test_wire_codec_source_is_the_original():
    got = (REPO / "qwen3_asr_swift_tpu_torch" / "runtime" / "wire_codec.cpp").read_bytes()
    assert got == (REPO / "qwen3_asr_swift_tpu" / "runtime" / "wire_codec.cpp").read_bytes()


@pytest.mark.parametrize("name", ["speech_core.cpp", "speech_core.h"])
def test_engine_sources_are_the_originals(name):
    got = (REPO / "qwen3_asr_swift_tpu_torch" / "runtime" / name).read_bytes()
    assert got == (REPO / "qwen3_asr_swift_tpu" / "runtime" / name).read_bytes()


def test_logging_categories_and_engine_marker_match():
    for name in ("model_loading", "inference", "download", "pipeline", "serving"):
        assert getattr(p_logging, name).name == getattr(j_logging, name).name, name
    assert p_engine.TOOL_MARKER == j_engine.TOOL_MARKER
    assert p_engine.tool_call("lights", "on") == j_engine.tool_call("lights", "on")
    assert dataclasses.asdict(p_chat.CONFIG_08B) == dataclasses.asdict(j_chat.CONFIG_08B)


@pytest.mark.parametrize("text", ["hello world", "héllo, 世界! 4567", "<|im_start|>wo<|im_end|>"])
@pytest.mark.parametrize("skip_special", [True, False])
def test_streaming_decoder_matches(text, skip_special):
    """Token by token, the port's ``StreamingDecoder`` gives the reference's
    pieces (multi-byte characters withheld until whole), and the joined
    text is the tokenizer's decode."""
    vocab, merges, special = _toy_vocab()
    port, ref = p_bpe.BPETokenizer(vocab, merges, special), j_bpe.BPETokenizer(vocab, merges, special)
    ids = ref.encode(text) + [9999]  # an unknown id yields nothing
    p_dec = p_bpe.StreamingDecoder(port, skip_special=skip_special)
    j_dec = j_bpe.StreamingDecoder(ref, skip_special=skip_special)
    got = [p_dec.push(t) for t in ids] + [p_dec.finish()]
    want = [j_dec.push(t) for t in ids] + [j_dec.finish()]
    assert got == want
    assert "".join(got) == ref.decode(ref.encode(text), skip_special=skip_special)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_nothing_of_the_jax_package():
    files = sorted((REPO / "qwen3_asr_swift_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = {}
    for f in files:
        mods = [m for m in _imported_modules(f)
                if m == "qwen3_asr_swift_tpu" or m.startswith("qwen3_asr_swift_tpu.")
                or m == "jax" or m.startswith("jax.")]
        if mods:
            bad[os.path.relpath(f, REPO)] = mods
    assert not bad, bad


@pytest.mark.parametrize("seed", range(4))
def test_text_chunker_matches(seed):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta,", "gamma.", "delta!", "3.14", "你好。", "世界，", "x" * 40, "why?"]
    text = " ".join(rng.choice(words, size=int(rng.integers(1, 60))))
    for max_chars in (12, 40, 300):
        assert p_chunker.chunk_text(text, max_chars) == j_chunker.chunk_text(text, max_chars)


def test_cosyvoice_vibevoice_constants_and_solver_match():
    for name in ("NEGATIVE_TEXT_ID", "SPEECH_START_ID", "SPEECH_END_ID", "SPEECH_DIFFUSION_ID",
                 "SYSTEM_PROMPT"):
        assert getattr(p_vibe, name) == getattr(j_vibe, name), name
    for cls in ("CONFIG_05B",):
        assert dataclasses.asdict(getattr(p_cosy, cls)) == dataclasses.asdict(getattr(j_cosy, cls))
        assert dataclasses.asdict(getattr(p_vibe, cls)) == dataclasses.asdict(getattr(j_vibe, cls))
    for steps in (4, 20):
        for got, want in zip(p_vibe_diff.solver_coefficients(p_vibe_diff.DiffusionConfig(), steps),
                             j_vibe_diff.solver_coefficients(j_vibe_diff.DiffusionConfig(), steps)):
            np.testing.assert_array_equal(got, want)
    script = "A: hi there\nB: hello!\ncontinued\nnoise\nC_1 : bye"
    assert p_cosy.parse_dialogue(script) == j_cosy.parse_dialogue(script)


# whole modules the port carries unchanged (the kokoro and voxcpm2
# converters import their own package's configs and weights helpers)
WHOLE_COPIES = ["audio/ringbuffer.py", "audio/player.py", "ui/__init__.py", "ui/store.py",
                "models/kokoro/phonemizer.py", "models/kokoro/phonemizer_i18n.py",
                "models/kokoro/en_dict.py", "models/kokoro/convert.py",
                "models/voxcpm2/convert.py", "models/pyannote/convert.py",
                "models/firered_vad/convert.py", "models/speaker/convert.py",
                "models/speaker/campplus_convert.py", "models/separation/convert.py",
                "models/translation/convert.py", "models/diarization/pipeline.py",
                "models/pyannote/__init__.py", "models/firered_vad/__init__.py",
                "models/speaker/__init__.py", "models/separation/__init__.py",
                "models/translation/__init__.py",
                "models/wakeword/context_graph.py", "models/wakeword/kws_decoder.py",
                "models/wakeword/convert.py", "models/parakeet/config.py",
                "models/parakeet/convert.py", "models/parakeet_streaming/config.py",
                "models/parakeet_streaming/convert.py", "models/omnilingual/convert.py",
                "models/diarization/sortformer_convert.py",
                "models/wakeword/__init__.py", "models/parakeet/__init__.py",
                "models/parakeet_streaming/__init__.py", "models/omnilingual/__init__.py",
                "models/diarization/__init__.py", "core/hub.py"]


@pytest.mark.parametrize("path", WHOLE_COPIES)
def test_whole_copies_are_the_originals(path):
    got = (REPO / "qwen3_asr_swift_tpu_torch" / path).read_bytes()
    assert got == (REPO / "qwen3_asr_swift_tpu" / path).read_bytes()


def test_loader_copy_differs_only_in_device_memory():
    """core/loader.py is a copy but for ``device_memory_bytes`` (the card's
    ``total_memory``; the reference's 16 GiB for an explicit CPU device; a
    missing card raises) and ``can_fit``, which passes the device on."""
    import torch

    assert p_loader.device_memory_bytes("cpu") == j_loader.device_memory_bytes() == 16 << 30
    assert p_loader.can_fit(12 << 30, device="cpu") == j_loader.can_fit(12 << 30)
    assert p_loader.can_fit(14 << 30, device="cpu") == j_loader.can_fit(14 << 30)
    if torch.cuda.is_available():
        want = torch.cuda.get_device_properties(0).total_memory
        assert p_loader.device_memory_bytes() == p_loader.device_memory_bytes("cuda:0") == want
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_loader.device_memory_bytes()
    for gib in (8, 16, 24, 40, 64, 96):
        assert (p_loader.MemoryTier.detect(gib << 30).name
                == j_loader.MemoryTier.detect(gib << 30).name)


@pytest.mark.parametrize("seed", range(3))
def test_ring_buffer_and_store_copies_behave_as_the_originals(seed):
    rng = np.random.default_rng(seed)
    rings = p_ring.AudioRingBuffer(50), j_ring.AudioRingBuffer(50)
    for _ in range(20):
        op = rng.integers(3)
        n = int(rng.integers(0, 70))
        if op == 0:
            x = rng.standard_normal(n).astype(np.float32)
            for r in rings:
                r.write(x)
        outs = [r.read(n) if op == 1 else r.peek_last(n) for r in rings]
        np.testing.assert_array_equal(*outs)
        assert rings[0].available == rings[1].available
    stores = p_store.TranscriptionStore(), j_store.TranscriptionStore()
    for i in range(6):
        for st in stores:
            st.update_partial(f"part {i}")
            if i % 2:
                st.commit(f"line {i}", start=float(i), end=i + 0.5)
    assert stores[0].transcript == stores[1].transcript
    assert [dataclasses.astuple(a)[:3] for a in stores[0].segments] == \
        [dataclasses.astuple(a)[:3] for a in stores[1].segments]


def test_models_package_lists_every_family():
    """The port's model directories are the families it has ported, and the
    package's docstring names each."""
    from qwen3_asr_swift_tpu_torch import models

    families = {"qwen3_asr", "silero_vad", "qwen3_tts", "cosyvoice", "vibevoice", "kokoro",
                "voxcpm2", "enhancement", "personaplex", "chat", "pyannote", "firered_vad",
                "speaker", "diarization", "separation", "translation", "wakeword", "parakeet",
                "parakeet_streaming", "omnilingual"}
    on_disk = {d.name for d in (REPO / "qwen3_asr_swift_tpu_torch" / "models").iterdir()
               if (d / "__init__.py").exists()}
    assert on_disk == families
    assert all(f"``{f}``" in models.__doc__ for f in families)


def test_speaker_vad_separation_translation_configs_match():
    """The new families' configurations, published and tiny, equal the
    reference's field for field, and so do the module constants."""
    pairs = [(p_pyannote.SEGMENTATION_30, j_pyannote.SEGMENTATION_30),
             (p_pyannote.config_tiny(), j_pyannote.config_tiny()),
             (p_firered.CONFIG_FIRERED, j_firered.CONFIG_FIRERED),
             (p_firered.config_tiny(), j_firered.config_tiny()),
             (p_campplus.CONFIG_CAMPPLUS, j_campplus.CONFIG_CAMPPLUS),
             (p_campplus.config_tiny(), j_campplus.config_tiny()),
             (p_translation.CONFIG_3B, j_translation.CONFIG_3B),
             (p_translation.config_tiny(), j_translation.config_tiny()),
             (p_translation.config_tiny(64), j_translation.config_tiny(64))]
    for got, want in pairs:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert p_campplus.CONFIG_CAMPPLUS.head_out == j_campplus.CONFIG_CAMPPLUS.head_out == 320
    for name in ("STEMS", "N_FFT", "HOP", "SR"):
        assert getattr(p_separation, name) == getattr(j_separation, name), name
    assert p_pyannote._POWERSET == j_pyannote._POWERSET
    from qwen3_asr_swift_tpu.models.speaker import model as j_wes
    from qwen3_asr_swift_tpu_torch.models.speaker import model as p_wes

    assert p_wes.WeSpeaker.FBANK_BUCKETS_S == j_wes.WeSpeaker.FBANK_BUCKETS_S
    assert (p_campplus.CampPlusSpeaker.FBANK_BUCKETS_S
            == j_campplus.CampPlusSpeaker.FBANK_BUCKETS_S)


@pytest.mark.parametrize("seed", range(3))
def test_copied_clustering_and_der_behave_as_the_originals(seed):
    from qwen3_asr_swift_tpu.models.diarization import pipeline as j_pipe
    from qwen3_asr_swift_tpu_torch.models.diarization import pipeline as p_pipe

    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((25, 6))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for kw in ({"threshold": 0.4}, {"threshold": 0.4, "num_clusters": 3},
               {"threshold": 0.01, "max_clusters": 4}):
        np.testing.assert_array_equal(p_pipe.agglomerative_cluster(emb, **kw),
                                      j_pipe.agglomerative_cluster(emb, **kw))
    edges = np.sort(rng.uniform(0, 20, 12))
    ref = [(edges[i], edges[i + 1], int(rng.integers(3))) for i in range(0, 12, 2)]
    hyp = [(a + rng.uniform(-0.3, 0.3), b + rng.uniform(-0.3, 0.3), int(rng.integers(3)))
           for a, b, _ in ref]
    got = p_pipe.diarization_error_rate([p_types.DiarizedSegment(*r) for r in ref],
                                        [p_types.DiarizedSegment(*h) for h in hyp])
    want = j_pipe.diarization_error_rate([j_types.DiarizedSegment(*r) for r in ref],
                                         [j_types.DiarizedSegment(*h) for h in hyp])
    assert got == want


def test_protocols_and_cosine_similarity_match():
    a, b = np.random.default_rng(0).standard_normal((2, 16))
    assert (p_protocols.SpeakerEmbeddingModel.cosine_similarity(a, b)
            == j_protocols.SpeakerEmbeddingModel.cosine_similarity(a, b))
    import qwen3_asr_swift_tpu_torch.core as p_core

    for name in ("StreamingRecognitionModel", "SpeakerEmbeddingModel", "SpeakerDiarizationModel",
                 "SourceSeparationModel", "WakeWordModel", "TranslationModel", "DiarizedSegment"):
        assert getattr(p_core, name).__module__.startswith("qwen3_asr_swift_tpu_torch.core."), name
    assert dataclasses.astuple(p_types.DiarizedSegment(0.5, 1.0, 2)) == \
        dataclasses.astuple(j_types.DiarizedSegment(0.5, 1.0, 2))


def test_new_families_import_nothing_of_the_jax_package():
    """Running the new families and their CLI subcommands (``vad`` with
    each engine, ``diarize`` with each engine, ``embed-speaker`` with each
    model, ``separate``, ``translate``, ``wake``), ``clone_voice``, and
    Parakeet TDT, streaming Parakeet and Omnilingual at their tiny configs
    imports neither jax nor any module of the JAX package."""
    code = textwrap.dedent("""
        import contextlib, io, os, sys, tempfile
        import numpy as np
        from qwen3_asr_swift_tpu_torch import cli
        from qwen3_asr_swift_tpu_torch.audio.io import write_wav
        from qwen3_asr_swift_tpu_torch.models import (diarization, firered_vad, omnilingual,
                                                      parakeet, parakeet_streaming, pyannote,
                                                      separation, speaker, translation, wakeword)
        from qwen3_asr_swift_tpu_torch.models.cosyvoice import CosyVoiceTTS, config_tiny
        tts = CosyVoiceTTS.init_random(config_tiny(), device="cpu")
        tts.clone_voice("v", np.full(16000, 0.1, np.float32),
                        speaker_model=speaker.CampPlusSpeaker.init_random(device="cpu"))
        with tempfile.TemporaryDirectory() as d:
            clip = os.path.join(d, "clip.wav")
            t = np.arange(32000) / 16000
            write_wav(clip, (0.3 * np.sin(2 * np.pi * 200 * t) * (t > 0.5)).astype(np.float32),
                      16000)
            with contextlib.redirect_stdout(io.StringIO()):
                for argv in (["vad", clip, "--engine", "pyannote"],
                             ["vad", clip, "--engine", "firered"], ["diarize", clip],
                             ["embed-speaker", clip], ["embed-speaker", clip, "--model", "cam++"],
                             ["separate", clip, "--stems", "bass",
                              "--output-prefix", os.path.join(d, "s")],
                             ["translate", "hello"], ["wake", clip],
                             ["diarize", clip, "--engine", "sortformer"]):
                    cli.main(["--device", "cpu", argv[0], "--random-weights", *argv[1:]])
        clip = np.full(24000, 0.1, np.float32)
        parakeet.ParakeetASR.init_random(parakeet.config_tiny(), device="cpu").transcribe(clip)
        parakeet_streaming.ParakeetStreamingASR.init_random(device="cpu").transcribe(clip)
        omnilingual.OmnilingualASR.init_random(device="cpu").transcribe(clip)
        assert "jax" not in sys.modules, [k for k in sys.modules if k.startswith("jax")]
        ref = [k for k in sys.modules
               if k == "qwen3_asr_swift_tpu" or k.startswith("qwen3_asr_swift_tpu.")]
        assert not ref, ref
        print("OK")
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")
