"""The port's own ``SpeechServer`` (``/health``, ``/transcribe``; the
unported routes answer 404), and the thread safety the two batcher workers
need."""

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
    server = SpeechServer(build_registry(model), port=0)

    async def ask():
        await server.start()
        port = server._server.sockets[0].getsockname()[1]

        def request():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                conn.request(method, path, body=b"{}" if method == "POST" else None,
                             headers={"Upgrade": "websocket", "Connection": "Upgrade",
                                      "Sec-WebSocket-Key": "dGhlIHNhbXBsZSBub25jZQ=="})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        try:
            return await asyncio.get_running_loop().run_in_executor(None, request)
        finally:
            await server.stop()

    status, payload = asyncio.run(ask())
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
