"""The port's voice agent (its copy of the C++ engine, built with g++, and
its ctypes bindings) against the JAX package's.

- The reference's scripted cases (``tests/test_voice_pipeline.py``: a full
  turn, ``push_text``, echo, a tool call and its cooldown, an unknown tool,
  transcribe-only, eager STT, barge-in on and off, the onset chunk) run
  through the port's ``VoicePipeline`` with the reference's assertions, and
  the full turn, echo and tool cases give the same events (type, text, aux;
  state changes aside) through both packages.
- A full stack of the port's tiny models on the CPU — Silero VAD, Qwen3-ASR,
  Qwen3.5 chat and Qwen3-TTS — through the engine: the final transcript is
  the JAX ASR's on the samples the STT adapter received, the reply the JAX
  chat's greedy reply to that transcript, and the audio chunks the int16 of
  the TTS model's ``synthesize`` of the reply.
"""

import dataclasses
import queue
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu import pipeline as jpipe
from qwen3_asr_swift_tpu_torch import pipeline as ppipe
from qwen3_asr_swift_tpu_torch.pipeline import (PipelineConfig, PipelineEventType, PipelineState,
                                                VoicePipeline, tool_call)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

SPEECH = (0.5 * np.ones(512 * 12)).astype(np.float32)
SILENCE = np.zeros(512 * 12, np.float32)


def fake_vad(threshold=0.05):
    def vad(chunk):
        return 0.9 if np.abs(chunk).mean() > threshold else 0.05

    return vad


def wait_for(pipeline, etype, timeout=10.0):
    deadline = time.time() + timeout
    seen = []
    while time.time() < deadline:
        try:
            ev = pipeline.events.get(timeout=0.1)
        except queue.Empty:
            continue
        seen.append(ev)
        if ev.type.name == etype.name:
            return ev, seen
    raise AssertionError(f"no {etype} within {timeout}s; saw {[e.type for e in seen]}")


def make_pipeline(pkg=ppipe, **kw):
    cfg = pkg.PipelineConfig(min_speech_s=0.05, min_silence_s=0.1, pre_speech_s=0.1,
                             tool_cooldown_s=0.5, eager_stt=False)
    defaults = dict(vad=fake_vad(), stt=lambda audio: f"heard {len(audio)}",
                    llm=lambda text: f"reply to [{text}]",
                    tts=lambda text: np.zeros(8000, np.int16), config=cfg)
    defaults.update(kw)
    return pkg.VoicePipeline(**defaults)


def test_library_builds_from_the_ports_sources():
    lib = ppipe.ensure_library()
    assert lib.exists() and lib.parent.name == "build" and "speechcore_" in lib.name
    assert lib.parent.parent.name == "qwen3_asr_swift_tpu_torch"


def test_full_turn():
    with make_pipeline() as p:
        assert p.is_running
        p.push_audio(SPEECH)
        wait_for(p, PipelineEventType.SPEECH_STARTED)
        p.push_audio(SILENCE)
        ev, _ = wait_for(p, PipelineEventType.FINAL_TRANSCRIPT)
        assert ev.text.startswith("heard ")
        ev, _ = wait_for(p, PipelineEventType.RESPONSE_TEXT)
        assert ev.text.startswith("reply to [heard")
        ev, _ = wait_for(p, PipelineEventType.AUDIO_CHUNK)
        assert ev.pcm is not None and len(ev.pcm) > 0
    assert not p.is_running


def test_push_text_echo_and_state():
    with make_pipeline() as p:
        p.push_text("typed input")
        ev, _ = wait_for(p, PipelineEventType.RESPONSE_TEXT)
        assert ev.text == "reply to [typed input]"
    with make_pipeline(llm=None) as p:
        p.push_text("echo me")
        ev, _ = wait_for(p, PipelineEventType.RESPONSE_TEXT)
        assert ev.text == "echo me"
    p = make_pipeline()
    assert p.state == PipelineState.IDLE
    p.start()
    time.sleep(0.2)
    assert p.state == PipelineState.LISTENING
    p.stop()
    p.close()


def test_tool_call_cooldown_and_unknown_tool():
    with make_pipeline(llm=lambda text: tool_call("lights", "on")) as p:
        p.add_tool("lights", "control lights")
        p.push_text("turn on the lights")
        ev, _ = wait_for(p, PipelineEventType.TOOL_CALL)
        assert ev.text == "lights" and ev.aux == "on"
        p.push_text("again")
        ev, _ = wait_for(p, PipelineEventType.ERROR)
        assert "cooldown" in ev.aux
        time.sleep(0.6)
        p.push_text("once more")
        wait_for(p, PipelineEventType.TOOL_CALL)
    with make_pipeline(llm=lambda text: tool_call("nuke", "now")) as p:
        p.push_text("hi")
        ev, _ = wait_for(p, PipelineEventType.ERROR)
        assert ev.text == "nuke"


def test_transcribe_only_no_errors_and_onset_chunk():
    lens = []
    with make_pipeline(stt=lambda a: (lens.append(len(a)), "t")[1], llm=None, tts=None) as p:
        p.push_audio(SPEECH)
        p.push_audio(SILENCE)
        _, seen = wait_for(p, PipelineEventType.FINAL_TRANSCRIPT)
        deadline = time.time() + 5
        while time.time() < deadline and p.state != PipelineState.LISTENING:
            time.sleep(0.05)
        assert p.state == PipelineState.LISTENING
        time.sleep(0.3)
        try:
            while True:
                seen.append(p.events.get_nowait())
        except queue.Empty:
            pass
        assert not [e.aux for e in seen if e.type == PipelineEventType.ERROR]
    assert lens and lens[0] % 512 == 0 and lens[0] // 512 <= 12 + 4


def test_eager_stt_emits_partial():
    cfg = PipelineConfig(min_speech_s=0.05, min_silence_s=0.4, pre_speech_s=0.1, eager_stt=True)
    with VoicePipeline(vad=fake_vad(), stt=lambda a: f"heard {len(a)}", llm=None, tts=None,
                       config=cfg) as p:
        p.push_audio(SPEECH)
        wait_for(p, PipelineEventType.SPEECH_STARTED)
        p.push_audio(np.zeros(512 * 20, np.float32))
        ev, _ = wait_for(p, PipelineEventType.PARTIAL_TRANSCRIPT)
        assert ev.text.startswith("heard ")
        wait_for(p, PipelineEventType.FINAL_TRANSCRIPT)


@pytest.mark.parametrize("allow", [True, False])
def test_barge_in(allow):
    n_chunks = 156 if allow else 10
    cfg = PipelineConfig(min_speech_s=0.05, min_silence_s=0.1, pre_speech_s=0.1,
                         eager_stt=False, allow_interruption=allow,
                         speak_chunk=2048 if allow else 4096)
    with VoicePipeline(vad=fake_vad(), stt=lambda a: "hi", llm=lambda t: "a reply",
                       tts=lambda t: np.zeros(n_chunks * cfg.speak_chunk, np.int16),
                       config=cfg) as p:
        p.push_text("user turn")
        p.push_audio(SPEECH)
        if allow:
            _, seen = wait_for(p, PipelineEventType.INTERRUPTED, timeout=20)
            assert len([e for e in seen if e.type == PipelineEventType.AUDIO_CHUNK]) < n_chunks
            return
        deadline = time.time() + 10
        chunks, interrupted = 0, False
        while time.time() < deadline and chunks < n_chunks:
            try:
                ev = p.events.get(timeout=0.1)
            except queue.Empty:
                continue
            chunks += ev.type == PipelineEventType.AUDIO_CHUNK
            interrupted |= ev.type == PipelineEventType.INTERRUPTED
        assert chunks == n_chunks and not interrupted


def scenario_events(pkg, scenario):
    """The events of one scripted scenario through ``pkg``'s pipeline, up to
    its last expected event: [(type name, text, aux, pcm length)] without
    the state changes."""
    if scenario == "turn":
        p, last = make_pipeline(pkg), "AUDIO_CHUNK"
    elif scenario == "echo":
        p, last = make_pipeline(pkg, llm=None), "AUDIO_CHUNK"
    else:
        p, last = make_pipeline(pkg, llm=lambda text: tool_call("lights", "on")), "TOOL_CALL"
    with p:
        if scenario == "turn":
            p.push_audio(SPEECH)
            p.push_audio(SILENCE)
        elif scenario == "echo":
            p.push_text("echo me")
        else:
            p.add_tool("lights", "control lights")
            p.push_text("lights please")
        _, seen = wait_for(p, getattr(pkg.PipelineEventType, last))
    return [(e.type.name, e.text, e.aux, None if e.pcm is None else len(e.pcm))
            for e in seen if e.type.name != "STATE_CHANGED"]


@pytest.mark.parametrize("scenario", ["turn", "echo", "tool"])
def test_events_equal_the_references(scenario):
    got, want = scenario_events(ppipe, scenario), scenario_events(jpipe, scenario)
    assert got == want
    assert got[-1][0] in ("AUDIO_CHUNK", "TOOL_CALL")


@pytest.mark.parametrize("pkg", [ppipe, jpipe], ids=["port", "reference"])
def test_failing_models(pkg):
    """A model that raises is logged; the engine turns a failed TTS into an
    ERROR event and a failed LLM into an empty reply, in both packages."""
    def broken(text):
        raise RuntimeError("no model")

    with make_pipeline(pkg, tts=broken) as p:
        p.push_text("hi")
        ev, _ = wait_for(p, pkg.PipelineEventType.ERROR)
        assert ev.aux == "tts failed"
    with make_pipeline(pkg, llm=broken) as p:
        p.push_text("hi")
        ev, _ = wait_for(p, pkg.PipelineEventType.RESPONSE_TEXT)
        assert ev.text is None or ev.text == ""


# ---------------------------------------------------------------------------
# a full stack of the port's tiny models
# ---------------------------------------------------------------------------

class Recording:
    """Delegates to ``model`` and records the audio its ``transcribe`` got."""

    def __init__(self, model):
        self.model = model
        self.audio = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def transcribe(self, audio, **kw):
        self.audio.append(np.array(audio))
        return self.model.transcribe(audio, **kw)


def test_full_stack_with_the_ports_tiny_models():
    from qwen3_asr_swift_tpu.models.chat import Qwen3Chat as JaxChat
    from qwen3_asr_swift_tpu.models.chat import model as jchat
    from qwen3_asr_swift_tpu.models.qwen3_asr import Qwen3ASR as JaxASR
    from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jasr_tiny
    from qwen3_asr_swift_tpu_torch.cli import byte_tokenizer, chat_tokenizer
    from qwen3_asr_swift_tpu_torch.core.params import init_random_params
    from qwen3_asr_swift_tpu_torch.models.chat import Qwen3Chat
    from qwen3_asr_swift_tpu_torch.models.chat import model as pchat
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny as asr_tiny
    from qwen3_asr_swift_tpu_torch.models.qwen3_tts import (Qwen3TTS, TTSSamplingConfig,
                                                            config_tiny as tts_tiny)
    from qwen3_asr_swift_tpu_torch.models.silero_vad import SileroVAD

    torch.set_num_threads(1)

    class EnergyVAD(SileroVAD):
        """The Silero chunk program runs (the adapter's ``process_chunk``
        path), with an energy decision laid over its random output."""

        def process_chunk(self, state, samples):
            state, _ = super().process_chunk(state, samples)
            return state, (0.9 if np.abs(samples).mean() > 0.05 else 0.05)

    enc, dec = init_random_params(asr_tiny(), seed=0)
    stt = Recording(Qwen3ASR(asr_tiny(), enc, dec, device="cpu", dtype=torch.float32,
                             audio_buckets_s=(8,)))
    stt.model.max_tokens = 6
    ref_stt = JaxASR(jasr_tiny(), enc, dec, dtype=jnp.float32, audio_buckets_s=(8,))
    ccfg = pchat.config_tiny(vocab=260)
    chat_params = pchat.init_chat_params(np.random.default_rng(1), ccfg)
    llm = Qwen3Chat(ccfg, chat_params, tokenizer=chat_tokenizer(256), device="cpu")
    llm.max_new = 8
    ref_llm = JaxChat(jchat.ChatConfig(**dataclasses.asdict(ccfg)), chat_params,
                      tokenizer=chat_tokenizer(256))
    tts = Qwen3TTS.init_random(tts_tiny(), 0, device="cpu", dtype=torch.float32,
                               tokenizer=byte_tokenizer())
    tts.sampling = TTSSamplingConfig(temperature=0.0, max_frames=3)
    vad = EnergyVAD.init_random(0, device="cpu")

    cfg = PipelineConfig(min_speech_s=0.05, min_silence_s=0.1, pre_speech_s=0.1,
                         vad_onset=0.3, vad_offset=0.2, eager_stt=False)
    with VoicePipeline(stt=stt, tts=tts, vad=vad, llm=llm, config=cfg) as p:
        rng = np.random.default_rng(0)
        p.push_audio((0.5 * rng.standard_normal(512 * 16)).astype(np.float32))
        p.push_audio(np.zeros(512 * 16, np.float32))
        final, seen = wait_for(p, PipelineEventType.FINAL_TRANSCRIPT, timeout=120)
        reply, more = wait_for(p, PipelineEventType.RESPONSE_TEXT, timeout=120)
        seen += more
        time.sleep(0.1)
        while p.state == PipelineState.SPEAKING or not p.events.empty():
            try:
                seen.append(p.events.get(timeout=1.0))
            except queue.Empty:
                break
    assert not [e.aux for e in seen if e.type == PipelineEventType.ERROR]
    assert len(stt.audio) == 1
    want_text = ref_stt.transcribe(stt.audio[0], sample_rate=16000, max_tokens=6).text
    assert final.text == want_text
    ids = llm.tokenizer.encode(JaxChat.apply_chat_template([{"role": "user", "content": final.text}]))
    want_reply = llm.tokenizer.decode(ref_llm.generate_ids(ids, max_new=8), skip_special=True)
    assert reply.text == want_reply
    pcm = np.concatenate([e.pcm for e in seen if e.type == PipelineEventType.AUDIO_CHUNK])
    direct = tts.synthesize(reply.text)
    np.testing.assert_array_equal(pcm, (np.clip(direct.samples, -1, 1) * 32767.0).astype(np.int16))
