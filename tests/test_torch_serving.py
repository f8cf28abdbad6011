"""The port's own ``SpeechServer`` (``/health``, ``/transcribe``; ``/speak``,
``/respond`` and ``/enhance`` answer 503 without their models, ``/v1/realtime``
the WebSocket handshake, unknown routes 404), and the thread safety the two
batcher workers need."""

import asyncio
import http.client
import json
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu_torch.audio import wav_bytes
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.ops.cuda_build import LaunchCounter
from qwen3_asr_swift_tpu_torch.serving import SpeechServer, build_registry


@pytest.fixture(scope="module")
def model():
    return Qwen3ASR.init_random(config_tiny(), 0, device="cpu", dtype=torch.float32,
                                audio_buckets_s=(8,), wire_dtype="dpcm4", decode_chunk_tokens=4)


def test_server_answers_transcribe_and_health(model):
    server = SpeechServer(build_registry(model), port=0)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=30)
        port = server._server.sockets[0].getsockname()[1]
        rng = np.random.default_rng(0)

        def request(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                conn.request(method, path, body=body,
                             headers={"Content-Type": "audio/wav"} if body else {})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        bodies = [wav_bytes((0.1 * rng.standard_normal(n)).astype(np.float32), 16000)
                  for n in (8000, 16000, 24000)]
        with ThreadPoolExecutor(max_workers=4) as pool:
            answers = [f.result(timeout=300) for f in
                       [pool.submit(request, "POST", "/transcribe", b) for b in bodies]
                       + [pool.submit(request, "GET", "/health")]]
        for status, payload in answers[:3]:
            assert status == 200 and payload["text"], payload
        assert answers[3][0] == 200 and answers[3][1]["models_loaded"] == ["asr"]
        # the batcher attached its dispatch gate to the port's model
        assert model.dispatch_gate is not None
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()
    assert not thread.is_alive()


@pytest.mark.parametrize("method,path", [("POST", "/speak"), ("POST", "/respond"),
                                         ("POST", "/enhance"), ("GET", "/v1/realtime"),
                                         ("GET", "/nowhere")])
def test_unported_routes_answer_like_unknown_ones(model, method, path):
    """Every route of the reference is ported now: with only an ``asr`` entry
    in the registry, ``/speak``, ``/respond`` and ``/enhance`` answer the
    reference's 503s, ``/v1/realtime`` the WebSocket handshake (then the
    session's first event), and an unknown route 404."""
    import socket

    from qwen3_asr_swift_tpu_torch.serving.ws import accept_key

    server = SpeechServer(build_registry(model), port=0)
    ws_key = "dGhlIHNhbXBsZSBub25jZQ=="

    async def ask():
        await server.start()
        port = server._server.sockets[0].getsockname()[1]

        def request():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                body = b'{"text": "hello"}' if path == "/speak" else b"{}"
                conn.request(method, path, body=body if method == "POST" else None,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        def handshake():
            with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
                sock.sendall((f"{method} {path} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                              f"Connection: Upgrade\r\nSec-WebSocket-Key: {ws_key}\r\n"
                              "Sec-WebSocket-Version: 13\r\n\r\n").encode())
                data = b""
                while b"\r\n\r\n" not in data:
                    data += sock.recv(4096)
                head, _, rest = data.partition(b"\r\n\r\n")
                while len(rest) < 2 or len(rest) < 2 + (rest[1] & 0x7F):
                    rest += sock.recv(4096)
                first = json.loads(rest[2:2 + (rest[1] & 0x7F)])
                return head.decode(), first

        try:
            fn = handshake if path == "/v1/realtime" else request
            return await asyncio.get_running_loop().run_in_executor(None, fn)
        finally:
            await server.stop()

    status, payload = asyncio.run(ask())
    if path == "/speak":
        # /speak is ported (Qwen3-TTS): with no "tts" entry in the registry it
        # answers as the reference does
        assert status == 503 and payload == {"error": "no TTS model registered"}
    elif path == "/respond":
        assert status == 503 and payload == {"error": "no speech-to-speech model registered"}
    elif path == "/enhance":
        assert status == 503 and payload == {"error": "no enhancement model registered"}
    elif path == "/v1/realtime":
        lines = status.split("\r\n")
        assert lines[0] == "HTTP/1.1 101 Switching Protocols", lines
        assert f"Sec-WebSocket-Accept: {accept_key(ws_key)}" in lines
        assert payload["type"] == "session.created", payload
    else:
        assert status == 404 and payload == {"error": f"no route {method} {path}"}


def test_concurrent_transcribes_match_sequential(model):
    rng = np.random.default_rng(1)
    batches = [[(0.1 * rng.standard_normal(16000)).astype(np.float32)] for _ in range(4)]
    want = [model.transcribe_batch(b, max_tokens=6)[0].text for b in batches]
    with ThreadPoolExecutor(max_workers=4) as pool:
        got = [f.result(timeout=300) for f in
               [pool.submit(lambda b: model.transcribe_batch(b, max_tokens=6)[0].text, b)
                for b in batches]]
    assert got == want


def test_launch_counter_loses_no_update():
    counter = LaunchCounter("stress")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counter.add() for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.value == 16 * 2000
    counter.reset()
    assert counter.value == 0


def _post_json(server, body):
    async def ask():
        await server.start()
        port = server._server.sockets[0].getsockname()[1]

        def request():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                conn.request("POST", "/transcribe", body=json.dumps(body).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        try:
            return await asyncio.get_running_loop().run_in_executor(None, request)
        finally:
            await server.stop()

    return asyncio.run(ask())


@pytest.mark.parametrize("scheduler", ["group", "slotpool"])
def test_transcribe_json_body_takes_a_decode_budget(model, scheduler):
    import base64

    from qwen3_asr_swift_tpu_torch.core.types import to_float32

    pcm = (np.random.default_rng(2).standard_normal(16000) * 3000).astype("<i2")
    body = {"audio_base64": base64.b64encode(pcm.tobytes()).decode(), "max_tokens": 3}
    status, payload = _post_json(SpeechServer(build_registry(model), port=0,
                                              scheduler=scheduler), body)
    want = model.transcribe_batch([to_float32(pcm)], max_tokens=3)[0]
    assert status == 200 and payload["text"] == want.text, (payload, want.text)


@pytest.mark.parametrize("max_tokens", [0, "many"])
def test_transcribe_rejects_a_bad_decode_budget(model, max_tokens):
    import base64

    pcm = np.zeros(1600, "<i2")
    body = {"audio_base64": base64.b64encode(pcm.tobytes()).decode(), "max_tokens": max_tokens}
    status, payload = _post_json(SpeechServer(build_registry(model), port=0), body)
    assert status == 400 and "max_tokens" in payload["error"], payload
