"""Streaming ASR (VAD-gated segments, partials, finals) against the JAX
package's, over the same tiny ASR weights.

Both packages' ``StreamingASR`` are fed one stream in 100 ms pushes and
must emit identical events: the same partial/final flags, segment times
within 1e-6 s, and the same texts. The ASR is the group-64 tiny config
with its decoder dequantized to fp32 in both packages, so both compute one
fp32 function and the greedy tokens cannot differ on a rounding.

- With a VAD whose probabilities are scripted (the same subclass of each
  package's ``SileroVAD``), the segments are fixed and the test holds the
  host orchestration and the per-event transcription.
- With the random Silero network itself (the same weights in both), the
  thresholds are placed so that every probability clears them by more than
  ten times the 1e-5 to which the packages' probabilities agree: an event
  that flipped would fail the comparison loudly, never by chance.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.qwen3_asr import Qwen3ASR as JaxQwen3ASR
from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jax_tiny
from qwen3_asr_swift_tpu.models.qwen3_asr import streaming as j_streaming
from qwen3_asr_swift_tpu.models.silero_vad import model as j_vad
from qwen3_asr_swift_tpu_torch.core.params import init_random_params
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import streaming as p_streaming
from qwen3_asr_swift_tpu_torch.models.silero_vad import model as p_vad

SR = 16000
PIECE = SR // 10
MAX_TOKENS = 5


def shrink(cfg):
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))


CFG, JCFG = shrink(config_tiny()), shrink(jax_tiny())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Streaming runs chains of tiny ops: with several test workers on the
    host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def asrs():
    enc, dec = init_random_params(CFG, seed=0, quant_bits=4)
    port = Qwen3ASR(CFG, enc, dec, device="cpu", dtype=torch.float32, audio_buckets_s=(8,),
                    quant_compute="dequant")
    ref = JaxQwen3ASR(JCFG, enc, dec, dtype=jnp.float32, audio_buckets_s=(8,),
                      quant_compute="dequant")
    return port, ref


def scripted(base):
    """A VAD of ``base``'s class whose chunk probabilities are a script."""

    class Scripted(base):
        def __init__(self, probs):
            self.probs = list(probs)

        def new_stream(self):
            return 0

        def process_chunk(self, state, samples):
            return state + 1, float(self.probs[min(state, len(self.probs) - 1)])

    return Scripted


def stream_audio(seconds, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(seconds * SR))).astype(np.float32)


def run(streaming_mod, asr, vad, vad_cfg, audio):
    cfg = streaming_mod.StreamingASRConfig(max_tokens=MAX_TOKENS, vad=vad_cfg)
    s = streaming_mod.StreamingASR(asr, vad, cfg)
    events = []
    for i in range(0, len(audio), PIECE):
        events += s.push(audio[i:i + PIECE])
    return events + s.finish()


def assert_same_events(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_final == w.is_final
        assert g.segment_start == pytest.approx(w.segment_start, abs=1e-6)
        assert g.segment_end == pytest.approx(w.segment_end, abs=1e-6)
        assert g.text == w.text


def test_scripted_vad_events_identical(asrs):
    # 32 ms chunks: silence, 2.2 s of speech, a short gap, 1.6 s, silence,
    # then speech that runs to the end (closed by finish())
    script = [0.1] * 10 + [0.9] * 70 + [0.1] * 12 + [0.9] * 50 + [0.2] * 20 + [0.8] * 30
    audio = stream_audio(len(script) * 512 / SR, seed=3)
    vad_cfg = dict(onset=0.5, offset=0.35, min_speech_duration=0.25, min_silence_duration=0.1)
    port, ref = asrs
    got = run(p_streaming, port, scripted(p_vad.SileroVAD)(script),
              p_vad.VADConfig(**vad_cfg), audio)
    want = run(j_streaming, ref, scripted(j_vad.SileroVAD)(script),
               j_vad.VADConfig(**vad_cfg), audio)
    assert_same_events(got, want)
    assert any(not e.is_final for e in got) and sum(e.is_final for e in got) >= 3
    assert all(e.text for e in got)


def test_force_split_and_pre_roll_identical(asrs):
    """A segment longer than ``max_segment_duration`` is split; the onset
    confirmed a push later is seeded from the pre-roll."""
    script = [0.1] * 5 + [0.9] * 120 + [0.1] * 10
    audio = stream_audio(len(script) * 512 / SR, seed=4)
    port, ref = asrs
    events = {}
    for key, mod, asr, vad_mod in (("port", p_streaming, port, p_vad),
                                   ("ref", j_streaming, ref, j_vad)):
        cfg = mod.StreamingASRConfig(max_tokens=MAX_TOKENS, max_segment_duration=1.5,
                                     partial_interval=0.5,
                                     vad=vad_mod.VADConfig(min_speech_duration=0.3))
        s = mod.StreamingASR(asr, scripted(vad_mod.SileroVAD)(script), cfg)
        out = []
        for i in range(0, len(audio), PIECE):
            out += s.push(audio[i:i + PIECE])
        events[key] = out + s.finish()
    assert_same_events(events["port"], events["ref"])
    assert sum(e.is_final for e in events["port"]) >= 3


def test_random_silero_events_identical(asrs):
    from test_torch_silero_vad import bursts, clear_thresholds

    params = p_vad.init_params(0)
    audio = bursts(8.0, seed=5)
    pv, jv = p_vad.SileroVAD(params, device="cpu"), j_vad.SileroVAD(params)
    probs = pv.speech_probabilities(audio)
    np.testing.assert_allclose(probs, jv.speech_probabilities(audio), atol=1e-5, rtol=0)
    onset, offset = clear_thresholds(probs)
    vad_cfg = dict(onset=onset, offset=offset, min_speech_duration=0.25, min_silence_duration=0.1)
    port, ref = asrs
    got = run(p_streaming, port, pv, p_vad.VADConfig(**vad_cfg), audio)
    want = run(j_streaming, ref, jv, j_vad.VADConfig(**vad_cfg), audio)
    assert_same_events(got, want)
    assert any(e.is_final for e in got)


@pytest.mark.parametrize("a,b", [("the cat sat", "the cat ran"), ("", "x"), ("a b c", "a b c d")])
def test_longest_common_prefix_matches(a, b):
    assert p_streaming.longest_common_prefix(a, b) == j_streaming.longest_common_prefix(a, b)


def test_streaming_is_a_copy():
    for name in ("StreamingASR", "longest_common_prefix"):
        assert (inspect.getsource(getattr(p_streaming, name))
                == inspect.getsource(getattr(j_streaming, name))), name
