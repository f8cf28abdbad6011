"""The port's ``/v1/realtime`` WebSocket, ``/respond`` and ``/enhance``
against the JAX package's server, on the CPU.

- The port's ``serving/ws.py`` is the reference's: frames (server and
  masked client frames, every length form) byte for byte, and a fragmented
  message with a ping between its fragments parsed alike.
- A full realtime session over tiny ASR and TTS models (the same numpy
  weights in both packages, fp32; greedy TTS; the same decode budget):
  ``session.update``, 100 ms ``input_audio_buffer.append`` pieces,
  ``commit``, ``conversation.item.create`` and ``response.create`` give
  the reference server's event sequence and transcript, and audio deltas
  within the codec's tolerance (ROADMAP §3: 1e-3 of max |ref|, plus one
  PCM16 step) of the reference's.
- The error paths: invalid JSON, an unsupported event, a buffer overflow,
  a commit without an ASR model and a response without a TTS model.
- ``/respond`` and ``/enhance`` with their models registered: 200 and a
  WAV; ``format: "json"`` carries the text token ids and the audio of a
  direct ``respond`` with the same seed (within one PCM16 step and 1e-5
  of float rounding: the server computes on a worker thread).
"""

import asyncio
import base64
import functools
import http.client
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_asr_swift_tpu.models.qwen3_asr import Qwen3ASR as JaxASR
from qwen3_asr_swift_tpu.models.qwen3_tts import Qwen3TTS as JaxTTS
from qwen3_asr_swift_tpu.models.qwen3_tts import TTSSamplingConfig as JaxTTSSampling
from qwen3_asr_swift_tpu.serving import server as jserver
from qwen3_asr_swift_tpu.serving import ws as jws
from qwen3_asr_swift_tpu.tokenizers.bpe import BPETokenizer as JaxBPE
from qwen3_asr_swift_tpu_torch.audio.io import read_wav, wav_bytes
from qwen3_asr_swift_tpu_torch.core.params import init_random_params
from qwen3_asr_swift_tpu_torch.core.types import to_float32, to_pcm16
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny as asr_tiny
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import (Qwen3TTS, TTSSamplingConfig,
                                                        config_tiny as tts_tiny)
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import code_predictor as pcp
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import codec as pcodec
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import talker as ptalker
from qwen3_asr_swift_tpu_torch.serving import SpeechServer, build_registry
from qwen3_asr_swift_tpu_torch.serving import ws as pws
from qwen3_asr_swift_tpu_torch.tokenizers.bpe import BPETokenizer, _bytes_to_unicode

ASR_TOKENS = 12
TTS_FRAMES = 10
CODEC_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def byte_vocab():
    b2u = _bytes_to_unicode()
    return {b2u[b]: b for b in range(256)}


@pytest.fixture(scope="module")
def models():
    """(port asr, port tts, reference asr, reference tts) on shared weights;
    both ASRs decode ASR_TOKENS tokens and both TTSs synthesize greedily."""
    cfg = asr_tiny()
    enc, dec = init_random_params(cfg, seed=0)
    asr = Qwen3ASR(cfg, enc, dec, device="cpu", dtype=torch.float32, audio_buckets_s=(8,))
    asr.max_tokens = ASR_TOKENS
    from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jax_asr_tiny

    jasr = JaxASR(jax_asr_tiny(), enc, dec, dtype=jnp.float32, audio_buckets_s=(8,))
    jasr.transcribe_batch = functools.partial(jasr.transcribe_batch, max_tokens=ASR_TOKENS)
    tcfg = tts_tiny()
    rng = np.random.default_rng(0)
    t, c, k = (ptalker.init_talker_params(rng, tcfg.talker),
               pcp.init_cp_params(rng, tcfg.code_predictor),
               pcodec.init_codec_params(rng, tcfg.codec))
    tts = Qwen3TTS(tcfg, t, c, k, device="cpu", dtype=torch.float32,
                   tokenizer=BPETokenizer(byte_vocab(), []))
    tts.sampling = TTSSamplingConfig(temperature=0.0, max_frames=TTS_FRAMES)
    jtts = JaxTTS(tcfg, t, c, k, dtype=jnp.float32, tokenizer=JaxBPE(byte_vocab(), []))
    jtts.synthesize_stream = functools.partial(
        jtts.synthesize_stream, sampling=JaxTTSSampling(temperature=0.0, max_frames=TTS_FRAMES))
    return asr, tts, jasr, jtts


class Served:
    """A server on its own event loop thread, on a free port."""

    def __init__(self, server):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.server.start(), self.loop).result(timeout=30)
        self.port = self.server._server.sockets[0].getsockname()[1]
        return self

    def __exit__(self, *exc):
        asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(timeout=60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


def pcm_pieces(seconds=1.0, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 240 * t) + 0.05 * rng.standard_normal(len(t)))
    pcm = to_pcm16(audio.astype(np.float32)).tobytes()
    step = 1600 * 2                                  # 100 ms of PCM16
    return pcm, [pcm[i:i + step] for i in range(0, len(pcm), step)]


def session(port, events):
    """Send ``events`` (each followed by reading until its answers are in)
    and return every server event, in order."""
    client = pws.SyncWSClient("127.0.0.1", port, timeout=300)
    got = [client.recv_json()]
    try:
        for event, until in events:
            if isinstance(event, bytes):
                client.sock.sendall(pws.encode_client_frame(pws.OP_TEXT, event))
            else:
                client.send_json(event)
            while until:
                msg = client.recv_json()
                got.append(msg)
                if msg["type"] in until:
                    break
    finally:
        client.close()
    return got


def conversation():
    _, pieces = pcm_pieces()
    events = [({"type": "session.update", "session": {"input_audio_sample_rate": 16000}},
               ("session.updated",))]
    events += [({"type": "input_audio_buffer.append",
                 "audio": base64.b64encode(p).decode()}, ()) for p in pieces]
    events += [({"type": "input_audio_buffer.commit"},
                ("conversation.item.input_audio_transcription.completed",)),
               ({"type": "conversation.item.create",
                 "item": {"content": [{"type": "input_text", "text": "hello there"}]}},
                ("conversation.item.created",)),
               ({"type": "response.create"}, ("response.done",)),
               ({"type": "input_audio_buffer.clear"}, ("input_audio_buffer.cleared",))]
    return events


def audio_of(events):
    pcm = b"".join(base64.b64decode(e["delta"]) for e in events
                   if e["type"] == "response.audio.delta")
    return to_float32(np.frombuffer(pcm, dtype=np.int16))


def test_ws_codec_is_the_references(monkeypatch):
    assert pws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == jws.accept_key(
        "dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    monkeypatch.setattr("os.urandom", lambda n: bytes(range(7, 7 + n)))
    rng = np.random.default_rng(0)
    for n in (0, 5, 125, 126, 300, 65535, 65536, 70000):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for op, fin in ((pws.OP_TEXT, True), (pws.OP_BINARY, False), (pws.OP_CONT, True)):
            assert pws.encode_frame(op, payload, fin) == jws.encode_frame(op, payload, fin)
            assert (pws.encode_client_frame(op, payload, fin)
                    == jws.encode_client_frame(op, payload, fin))
    message = (pws.encode_client_frame(pws.OP_TEXT, b'{"type": "a', fin=False)
               + pws.encode_client_frame(pws.OP_PING, b"hi")
               + pws.encode_client_frame(pws.OP_CONT, b'bc"}') + pws.encode_frame(pws.OP_CLOSE, b""))

    async def parse(mod):
        reader = asyncio.StreamReader()
        reader.feed_data(message)
        reader.feed_eof()
        seen = []

        async def on_control(op, payload):
            seen.append((op, payload))

        first = await mod.read_message(reader, on_control=on_control)
        return first, seen, await mod.read_message(reader)

    assert asyncio.run(parse(pws)) == asyncio.run(parse(jws)) == (
        (pws.OP_TEXT, b'{"type": "abc"}'), [(pws.OP_PING, b"hi")], None)


def test_realtime_session_matches_reference(models):
    asr, tts, jasr, jtts = models
    with Served(SpeechServer(build_registry(asr, tts), port=0)) as served:
        got = session(served.port, conversation())
    registry = jserver.ModelRegistry()
    registry.register_instance("asr", jasr)
    registry.register_instance("tts", jtts)
    with Served(jserver.SpeechServer(registry, port=0)) as served:
        want = session(served.port, conversation())
    strip = [{k: v for k, v in e.items() if k != "delta"} for e in got]
    assert strip == [{k: v for k, v in e.items() if k != "delta"} for e in want]
    types = [e["type"] for e in got]
    assert types[:3] == ["session.created", "session.updated", "input_audio_buffer.committed"]
    assert types[-3:] == ["response.audio.done", "response.done", "input_audio_buffer.cleared"]
    assert "response.created" in types and "conversation.item.created" in types
    assert got[-2]["response"] == {"status": "completed"}
    # the transcript is the ASR model's own on the committed samples
    pcm, _ = pcm_pieces()
    done = next(e for e in got if e["type"].endswith("transcription.completed"))
    assert done["transcript"] == asr.transcribe(to_float32(np.frombuffer(pcm, np.int16))).text
    # the deltas are ~200 ms pieces of the model's own stream
    deltas = [e for e in got if e["type"] == "response.audio.delta"]
    assert len(deltas) > 1 and all(len(base64.b64decode(d["delta"])) <= 24000 // 5 * 2
                                   for d in deltas)
    direct = np.concatenate([c.samples for c in tts.synthesize_stream("hello there")])
    assert_same_audio(audio_of(got), direct)
    ref = audio_of(want)
    assert len(audio_of(got)) == len(ref) > 0
    assert np.abs(audio_of(got) - ref).max() <= CODEC_TOL * np.abs(ref).max() + 1 / 32768


def test_realtime_errors_match_reference(models):
    asr, tts, jasr, jtts = models
    big = base64.b64encode(b"\x01\x00" * 700).decode()
    events = [(b"{not json", ("error",)),
              ({"type": "no.such.event"}, ("error",)),
              ({"type": "input_audio_buffer.append", "audio": big}, ("error",)),
              ({"type": "response.create"}, ("response.done",)),
              ({"type": "input_audio_buffer.commit"}, ("error",))]
    got = session_with(SpeechServer(build_registry(), port=0, max_body=1000), events)
    registry = jserver.ModelRegistry()
    want = session_with(jserver.SpeechServer(registry, port=0, max_body=1000), events)
    assert got == want
    assert [e.get("error", {}).get("message") for e in got[1:]] == [
        "invalid JSON", "unsupported event 'no.such.event'",
        "input audio buffer overflow; buffer cleared", None, "no ASR model"]
    assert got[4]["response"] == {"status": "incomplete"}


def session_with(server, events):
    with Served(server) as served:
        return session(served.port, events)


@pytest.fixture(scope="module")
def s2s_and_enhancer():
    from qwen3_asr_swift_tpu_torch.models.enhancement import SpeechEnhancer
    from qwen3_asr_swift_tpu_torch.models.personaplex import PersonaPlex, config_tiny

    return (PersonaPlex.init_random(config_tiny(), 0, device="cpu"),
            SpeechEnhancer.init_random(0, device="cpu"))


def post(port, path, body, ctype):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def assert_same_audio(served, direct):
    """The served WAV is the direct call's output written as PCM16: within
    one PCM16 step, plus 1e-5 of max |direct| for the float rounding of the
    server's worker thread, whose BLAS may split a product across another
    number of threads than the caller's."""
    assert len(served) == len(direct) > 0
    tol = 1 / 32768 + 1e-5 * np.abs(direct).max()
    assert np.abs(served - to_float32(to_pcm16(direct))).max() <= tol


def test_respond_and_enhance_routes(s2s_and_enhancer):
    from qwen3_asr_swift_tpu_torch.models.personaplex import PersonaSampling

    s2s, enh = s2s_and_enhancer
    rng = np.random.default_rng(4)
    audio16 = (0.2 * rng.standard_normal(16000)).astype(np.float32)
    pcm = to_pcm16(audio16)
    with Served(SpeechServer(build_registry(enhance=enh, s2s=s2s), port=0)) as served:
        status, ctype, body = post(served.port, "/respond", wav_bytes(audio16, 16000),
                                   "audio/wav")
        assert status == 200 and ctype == "audio/wav"
        wav, rate = read_wav(body)
        assert rate == 24000 and len(wav) > 0
        payload = {"audio_base64": base64.b64encode(pcm.tobytes()).decode(), "max_steps": 6,
                   "seed": 3, "system_prompt": [5, 7], "format": "json"}
        status, _, body = post(served.port, "/respond", json.dumps(payload).encode(),
                               "application/json")
        out = json.loads(body)
        assert status == 200 and set(out) == {"duration", "audio_base64", "text_tokens",
                                              "text_token_ids"}
        direct = s2s.respond(to_float32(pcm), 16000, sampling=PersonaSampling(max_steps=6),
                             system_prompt=[5, 7], seed=3)
        assert out["text_token_ids"] == [int(t) for t in s2s.last_text_tokens]
        assert out["text_tokens"] == len(out["text_token_ids"]) == 6
        served_wav, _ = read_wav(base64.b64decode(out["audio_base64"]))
        assert_same_audio(served_wav, direct.samples)

        noisy = (0.2 * rng.standard_normal(12000)).astype(np.float32)
        status, ctype, body = post(served.port, "/enhance", wav_bytes(noisy, 48000), "audio/wav")
        assert status == 200 and ctype == "audio/wav"
        wav, rate = read_wav(body)
        assert rate == 48000 and len(wav) == len(noisy)
        sent = read_wav(wav_bytes(noisy, 48000))[0]      # the samples the server reads
        assert_same_audio(wav, enh.enhance(sent, 48000).samples)
        status, _, body = post(served.port, "/enhance", b"not a wav", "audio/wav")
        assert status == 400
