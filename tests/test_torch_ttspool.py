"""The port's SlotPoolTTS (frame-level continuous batching) and its TTS
serving: ``TTSBatcher`` and ``POST /speak`` under both schedulers.

The pool must reproduce the port's solo greedy ``synthesize`` exactly:
the same prompt, prefill and per-frame talker/CP math, only the
scheduling differs, and the finisher decodes at the solo path's frame
bucket, so the waveforms are equal sample for sample. The cases are those
of ``tests/test_ttspool.py`` for the JAX package's pool, on a dense fp32
tiny model; one case is held against the JAX package's solo
``synthesize`` on the same weights (codes identical; the waveform as
``tests/test_torch_qwen3_tts.py`` holds the decoder), and one runs the
pool over a packed model under ``quant_compute="fused"``. ``/speak`` with
``engine`` reaches the other TTS engines (CosyVoice, VibeVoice) through a
``TTSBatcher`` under either scheduler, as the reference routes them.
"""

import asyncio
import dataclasses
import http.client
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.qwen3_tts import Qwen3TTS as JaxTTS
from qwen3_asr_swift_tpu.models.qwen3_tts import TTSSamplingConfig as JaxSampling
from qwen3_asr_swift_tpu.tokenizers.bpe import BPETokenizer as JaxBPE
from qwen3_asr_swift_tpu_torch.audio import load_audio, wav_bytes
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import Qwen3TTS, TTSSamplingConfig, config_tiny
from qwen3_asr_swift_tpu_torch.models.qwen3_tts.code_predictor import init_cp_params
from qwen3_asr_swift_tpu_torch.models.qwen3_tts.codec import init_codec_params
from qwen3_asr_swift_tpu_torch.models.qwen3_tts.talker import init_talker_params
from qwen3_asr_swift_tpu_torch.serving import (SlotPoolTTS, SpeechServer, TTSBatcher,
                                               build_registry)
from qwen3_asr_swift_tpu_torch.tokenizers.bpe import BPETokenizer, _bytes_to_unicode

GREEDY = TTSSamplingConfig(temperature=0.0, top_k=0, max_frames=6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The frame loops are chains of small ops: with several test workers
    on the host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def byte_vocab():
    b2u = _bytes_to_unicode()
    return {b2u[b]: b for b in range(256)}


@pytest.fixture(scope="module")
def model():
    return Qwen3TTS.init_random(config_tiny(), 0, device="cpu", dtype=torch.float32,
                                tokenizer=BPETokenizer(byte_vocab(), []))


def solo(model, text, **kw):
    return model.synthesize(text, sampling=GREEDY, **kw).samples


def pooled(model, texts, **kw):
    pool = SlotPoolTTS(model, sampling=GREEDY, **kw)
    try:
        futs = [pool.submit(t) for t in texts]
        return [f.result(timeout=300).samples for f in futs], pool.stats
    finally:
        pool.close()


def test_pooled_matches_solo_waveforms(model):
    texts = ["ab", "hello", "xyz", "q"]
    want = [solo(model, t) for t in texts]
    got, stats = pooled(model, texts, slots=4, tick_frames=2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert stats["requests_served"] == 4 and stats["ticks_run"] >= 1


def test_staggered_admission_and_slot_reuse(model):
    texts = ["ab", "cd", "ef", "gh", "ij"]
    want = [solo(model, t) for t in texts]
    pool = SlotPoolTTS(model, slots=2, tick_frames=2, sampling=GREEDY)
    try:
        first = [pool.submit(t) for t in texts[:2]]
        r0 = first[0].result(timeout=300)
        rest = [pool.submit(t) for t in texts[2:]]
        got = [r0.samples, first[1].result(timeout=300).samples] + \
              [f.result(timeout=300).samples for f in rest]
    finally:
        pool.close()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_budget_respected(model):
    pool = SlotPoolTTS(model, slots=1, tick_frames=2, sampling=GREEDY)
    try:
        short = pool.submit("hello world", max_frames=2).result(timeout=300)
        full = pool.submit("hello world").result(timeout=300)
    finally:
        pool.close()
    spf = model.cfg.codec.samples_per_frame
    assert len(short.samples) <= 2 * spf
    want_short = model.synthesize("hello world", sampling=dataclasses.replace(
        GREEDY, max_frames=2)).samples
    np.testing.assert_array_equal(short.samples, want_short)
    np.testing.assert_array_equal(full.samples, solo(model, "hello world"))
    assert short.sample_rate == 24000


def test_oversize_text_falls_back(model):
    long_text = "a" * 400   # blocks exceed a small arena
    pool = SlotPoolTTS(model, slots=1, tick_frames=2, sampling=GREEDY, max_p_block=32,
                       max_t_block=32, oversize="fallback")
    try:
        got = pool.submit(long_text).result(timeout=300)
        short = pool.submit("ab").result(timeout=300)
    finally:
        pool.close()
    np.testing.assert_array_equal(got.samples, solo(model, long_text))
    np.testing.assert_array_equal(short.samples, solo(model, "ab"))


def test_oversize_reject(model):
    pool = SlotPoolTTS(model, slots=1, sampling=GREEDY, max_p_block=32, max_t_block=32,
                       oversize="reject")
    try:
        with pytest.raises(ValueError, match="exceed"):
            pool.submit("a" * 400).result(timeout=300)
    finally:
        pool.close()
    with pytest.raises(ValueError, match="oversize"):
        SlotPoolTTS(model, oversize="drop")


def test_concurrent_submitters(model):
    texts = ["ab", "cd", "ef", "gh"]
    want = [solo(model, t) for t in texts]
    pool = SlotPoolTTS(model, slots=2, tick_frames=2, sampling=GREEDY)
    got = [None] * len(texts)
    try:
        def worker(i):
            got[i] = pool.submit(texts[i]).result(timeout=300).samples

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        pool.close()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_close_never_strands_a_future(model):
    pool = SlotPoolTTS(model, slots=1, tick_frames=2, sampling=GREEDY)
    futs = [pool.submit("ab") for _ in range(3)]
    closer = threading.Thread(target=pool.close)
    closer.start()
    outcomes = []
    for f in futs:
        try:
            outcomes.append(f.result(timeout=300) is not None)
        except RuntimeError as e:
            outcomes.append("closed" in str(e))
    closer.join(timeout=300)
    assert all(outcomes) and not closer.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit("late")


def test_pool_matches_the_jax_solo_path():
    """The port's pool against the JAX package's solo ``synthesize`` on
    the same weights: identical codes (the waveform is the codec decode of
    those codes, held in ``tests/test_torch_qwen3_tts.py``)."""
    cfg = config_tiny()
    rng = np.random.default_rng(3)
    t, c, k = (init_talker_params(rng, cfg.talker), init_cp_params(rng, cfg.code_predictor),
               init_codec_params(rng, cfg.codec))
    port = Qwen3TTS(cfg, t, c, k, device="cpu", dtype=torch.float32,
                    tokenizer=BPETokenizer(byte_vocab(), []))
    ref = JaxTTS(cfg, t, c, k, dtype=jnp.float32, tokenizer=JaxBPE(byte_vocab(), []),
                 quant_compute="packed")
    texts = ["ab", "hello there"]
    seen = []
    decode = port.codec.decode_frames
    port.codec.decode_frames = lambda codes, n: seen.append(codes[0, :n].cpu().numpy()) or \
        decode(codes, n)
    try:
        got, _ = pooled(port, texts, slots=2, tick_frames=3)
    finally:
        del port.codec.decode_frames
    for text, codes, wav in zip(texts, seen, got):
        want, n = ref.generate_codes(text, sampling=JaxSampling(temperature=0.0, top_k=0,
                                                                max_frames=6))
        np.testing.assert_array_equal(codes.T, want)
        assert len(wav) == n * 1920
    assert len(seen) == 2


def test_packed_pool_runs_k1_and_matches_solo(monkeypatch):
    from qwen3_asr_swift_tpu_torch.ops import quant

    cfg = config_tiny()
    cfg = dataclasses.replace(
        cfg, talker=dataclasses.replace(cfg.talker, hidden_size=128, intermediate_size=256,
                                        num_heads=4, num_kv_heads=4, head_dim=32,
                                        mrope_sections=(8, 4, 4)),
        code_predictor=dataclasses.replace(cfg.code_predictor, hidden_size=128,
                                           intermediate_size=256, num_heads=4, num_kv_heads=4,
                                           head_dim=32, embedding_dim=128))
    m = Qwen3TTS.init_random(cfg, 1, device="cpu", dtype=torch.float32, quant_bits=4,
                             quant_compute="fused", tokenizer=BPETokenizer(byte_vocab(), []))
    want = [solo(m, t) for t in ("ab", "cde")]
    calls = []
    k1 = quant.quant_matmul_cuda
    monkeypatch.setattr(quant, "quant_matmul_cuda", lambda x, p: calls.append(1) or k1(x, p))
    got, _ = pooled(m, ["ab", "cde"], slots=2, tick_frames=2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert calls


# --------------------------------------------------------------------------- #
# serving


def test_tts_batcher_groups_by_kwargs(model):
    batcher = TTSBatcher(model, max_batch=4, max_wait_ms=200, workers=1)
    try:
        futs = [batcher.submit(t, sampling=GREEDY) for t in ("ab", "cd", "ef")]
        other = batcher.submit("gh", sampling=GREEDY, language="german")
        got = [f.result(timeout=300).samples for f in futs]
        assert len(other.result(timeout=300).samples) > 0
    finally:
        batcher.shutdown()
    want = model.synthesize_batch(["ab", "cd", "ef"], sampling=GREEDY)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w.samples)
    assert batcher.stats["requests_served"] == 4 and batcher.stats["batches_run"] >= 2


def _serve(server, requests):
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(timeout=30)
        port = server._server.sockets[0].getsockname()[1]

        def ask(body):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            try:
                conn.request("POST", "/speak", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, resp.getheader("Content-Type", ""), resp.read()
            finally:
                conn.close()

        out = [None] * len(requests)
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, ask(requests[i])))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        return out
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()


@pytest.mark.parametrize("scheduler", ["group", "slotpool"])
def test_speak_route_answers_wav(model, scheduler, tmp_path):
    # the server's batchers sample as the model does by default: greedy with
    # a small budget keeps the test short
    saved, model.sampling = model.sampling, GREEDY
    try:
        server = SpeechServer(build_registry(tts=model), port=0, scheduler=scheduler,
                              max_batch=2)
        batcher = server._tts_batcher_for(model)
        if scheduler == "group":
            assert isinstance(batcher, TTSBatcher)
        else:
            assert isinstance(batcher, SlotPoolTTS) and batcher.sampling == GREEDY
            assert batcher.slots == 2 and batcher.oversize == "fallback"
        answers = _serve(server, [json.dumps({"text": t}).encode() for t in ("ab", "cd")]
                         + [json.dumps({"text": ""}).encode(),
                            json.dumps({"text": "ab", "engine": "kokoro"}).encode()])
    finally:
        model.sampling = saved
    assert batcher.stats["requests_served"] == 3
    for status, ctype, body in answers[:2] + answers[3:]:
        assert status == 200 and ctype.startswith("audio/wav"), (status, body[:200])
        path = tmp_path / "out.wav"
        path.write_bytes(body)
        audio, rate = load_audio(str(path), target_rate=24000)
        assert rate == 24000 and len(audio) % 1920 == 0 and len(audio) > 0
    assert answers[2][0] == 400 and json.loads(answers[2][2]) == {"error": "missing 'text' field"}
    # the last answer ("ab" through the default engine) is the solo
    # synthesis as 16-bit PCM; the group batcher may decode it in a batch,
    # at another frame bucket, so only the pool's is equal sample for sample
    heard, want = load_audio(str(path), target_rate=24000)[0], solo(model, "ab")
    assert heard.shape == want.shape
    if scheduler == "slotpool":
        assert answers[3][2] == wav_bytes(want, 24000)


def test_model_default_sampling_reaches_synthesize_and_the_pool(model):
    """A call or a pool given no sampling takes the model's (the
    reference's defaults until the caller sets ``model.sampling``)."""
    assert model.sampling == TTSSamplingConfig()
    want = solo(model, "hey")
    saved, model.sampling = model.sampling, GREEDY
    try:
        np.testing.assert_array_equal(model.synthesize("hey").samples, want)
        pool = SlotPoolTTS(model, slots=1, tick_frames=2)
        try:
            assert pool.sampling == GREEDY and pool.max_frames == GREEDY.max_frames
            np.testing.assert_array_equal(pool.submit("hey").result(timeout=300).samples, want)
        finally:
            pool.close()
    finally:
        model.sampling = saved


def test_speak_without_tts_answers_503(model):
    server = SpeechServer(build_registry(), port=0)
    (status, _, body), = _serve(server, [json.dumps({"text": "hello"}).encode()])
    assert status == 503 and json.loads(body) == {"error": "no TTS model registered"}


def test_concurrent_synthesize_matches_sequential(model):
    """Two TTSBatcher workers may run the model at once: each synthesis
    owns its cache and generator, so concurrent calls equal sequential
    ones."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    texts = ["ab", "cd", "efg", "hi", "jk", "lmn"]
    want = [solo(model, t) for t in texts]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=6) as ex:
            got = [f.result(timeout=300) for f in [ex.submit(solo, model, t) for t in texts]]
    finally:
        sys.setswitchinterval(old)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def other_engines():
    """Tiny CosyVoice, VibeVoice, Kokoro and VoxCPM2 on the CPU, each with a
    short cap."""
    from qwen3_asr_swift_tpu_torch.models.cosyvoice import CosyVoiceTTS
    from qwen3_asr_swift_tpu_torch.models.cosyvoice import config_tiny as cosy_tiny
    from qwen3_asr_swift_tpu_torch.models.kokoro import KokoroTTS
    from qwen3_asr_swift_tpu_torch.models.kokoro import config_tiny as kokoro_tiny
    from qwen3_asr_swift_tpu_torch.models.vibevoice import VibeVoiceTTS
    from qwen3_asr_swift_tpu_torch.models.vibevoice import config_tiny as vibe_tiny
    from qwen3_asr_swift_tpu_torch.models.voxcpm2 import VoxCPM2TTS
    from qwen3_asr_swift_tpu_torch.models.voxcpm2 import config_tiny as vox_tiny

    return {"cosyvoice": CosyVoiceTTS.init_random(cosy_tiny(), device="cpu"),
            "vibevoice": VibeVoiceTTS.init_random(vibe_tiny(), device="cpu"),
            "kokoro": KokoroTTS.init_random(kokoro_tiny(), device="cpu"),
            "voxcpm2": VoxCPM2TTS.init_random(vox_tiny(), device="cpu")}


@pytest.mark.parametrize("engine", ["cosyvoice", "vibevoice", "kokoro", "voxcpm2"])
@pytest.mark.parametrize("scheduler", ["group", "slotpool"])
def test_speak_engine_without_a_talker_takes_the_group_batcher(model, other_engines, engine,
                                                                scheduler):
    """``/speak`` with ``engine`` reaches ``tts:<engine>``. Under the slot pool
    only a model with a talker and a code predictor gets ``SlotPoolTTS``; the
    other engines get a ``TTSBatcher``, as in the reference, and answer the
    direct ``synthesize``'s samples."""
    tts = other_engines[engine]
    registry = build_registry(tts=model)
    registry.register_instance(f"tts:{engine}", tts)
    server = SpeechServer(registry, port=0, scheduler=scheduler, max_batch=2)
    (status, ctype, body), = _serve(server, [json.dumps({"text": "hello there",
                                                         "engine": engine}).encode()])
    assert status == 200 and ctype.startswith("audio/wav"), (status, body[:300])
    batcher = server._tts_batcher_for(tts)
    assert type(batcher) is TTSBatcher and batcher.stats["requests_served"] == 1
    want = tts.synthesize("hello there")
    assert len(want.samples) > 0 and body == wav_bytes(want.samples, want.sample_rate)
