"""The port's SlotPoolASR: token-level continuous batching correctness.

The pool must reproduce the port's solo ``transcribe`` exactly: the same
encode, prompt layout and decode math, only the scheduling differs. The
cases are those of ``tests/test_slotpool.py`` for the JAX package's pool,
on a dense fp32 tiny model and, for the main cases, on a packed 4-bit one
under ``quant.KERNEL = "plane"`` (on the CPU the K2 wrapper takes its plain
version). The packed pool admits one request per group there: a batched
prefill of more than 256 rows takes the plain fp32 product by the
reference's row rule, where a solo 8 s prompt (168 rows) takes K2's bf16
one, so the two would differ by design. One mixed-bucket case is held
against the JAX package's solo ``transcribe`` on the same weights, and the
port's ``SpeechServer`` serves ``/transcribe`` through the port's pool.
"""

import asyncio
import dataclasses
import http.client
import json
import threading
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.qwen3_asr import Qwen3ASR as JaxQwen3ASR
from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jax_tiny
from qwen3_asr_swift_tpu.ops.sampling import SamplingOptions as JaxOptions
from qwen3_asr_swift_tpu_torch.audio import wav_bytes
from qwen3_asr_swift_tpu_torch.core.params import init_random_params
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.ops import quant
from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions
from qwen3_asr_swift_tpu_torch.serving import SlotPoolASR, SpeechServer, build_registry
from qwen3_asr_swift_tpu_torch.serving.slotpool import _Req

MAX_NEW = 10
BUCKETS = (8, 16)


def packed_cfg():
    cfg = config_tiny()
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))


@pytest.fixture(scope="module")
def dense_weights():
    return init_random_params(config_tiny(), seed=0)


@pytest.fixture(scope="module")
def model(dense_weights):
    return Qwen3ASR(config_tiny(), *dense_weights, device="cpu", dtype=torch.float32,
                    audio_buckets_s=BUCKETS, wire_dtype="mulaw")


@pytest.fixture(scope="module")
def packed_model():
    return Qwen3ASR.init_random(packed_cfg(), 1, device="cpu", dtype=torch.float32,
                                quant_bits=4, audio_buckets_s=BUCKETS, wire_dtype="mulaw")


@pytest.fixture(params=["dense", "packed-plane"])
def any_model(request, model, packed_model, monkeypatch):
    """(model, admit_batch) for the two decoders."""
    if request.param == "dense":
        return model, 4
    monkeypatch.setattr(quant, "KERNEL", "plane")
    return packed_model, 1


def clips(n, seed=0, seconds=(2, 3, 9, 4)):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(16000 * seconds[i % len(seconds)])).astype(np.float32)
            for i in range(n)]


def solo(model, audio, max_new=MAX_NEW, **kw):
    return model.transcribe(audio, options=SamplingOptions(max_tokens=max_new), **kw)


def make_pool(model, **kw):
    kw.setdefault("max_new", MAX_NEW)
    kw.setdefault("tick_tokens", 4)
    kw.setdefault("max_len", 512)
    return SlotPoolASR(model, **kw)


def test_matches_solo_transcripts(any_model):
    m, admit_batch = any_model
    cs = clips(4)
    want = [solo(m, c).text for c in cs]
    pool = make_pool(m, slots=4, admit_batch=admit_batch)
    try:
        got = [r.text for r in pool.transcribe_all(cs)]
    finally:
        pool.close()
    assert got == want


def test_mixed_buckets_in_one_pool(any_model):
    # 2 s and 9 s clips take different audio buckets (8 s / 16 s) and
    # decode in the same tick
    m, admit_batch = any_model
    cs = [clips(1, seed=1, seconds=(2,))[0], clips(1, seed=2, seconds=(9,))[0]]
    want = [solo(m, c).text for c in cs]
    pool = make_pool(m, slots=2, admit_batch=admit_batch)
    try:
        got = [f.result(timeout=120).text for f in [pool.submit(c) for c in cs]]
    finally:
        pool.close()
    assert got == want


def test_mixed_buckets_match_the_jax_solo_path(dense_weights):
    """The port's pool against the JAX package's solo ``transcribe`` on the
    same weights: one request per audio bucket, token for token."""
    cs = [clips(1, seed=21, seconds=(3,))[0], clips(1, seed=22, seconds=(10,))[0]]
    jm = JaxQwen3ASR(jax_tiny(), *dense_weights, dtype=jnp.float32, audio_buckets_s=BUCKETS,
                     wire_dtype="mulaw")
    want = [jm.transcribe(c, options=JaxOptions(max_tokens=MAX_NEW)).text for c in cs]
    port = Qwen3ASR(config_tiny(), *dense_weights, device="cpu", dtype=torch.float32,
                    audio_buckets_s=BUCKETS, wire_dtype="mulaw")
    pool = make_pool(port, slots=2)
    try:
        got = [f.result(timeout=120).text for f in [pool.submit(c) for c in cs]]
    finally:
        pool.close()
    assert got == want and all(len(t.split()) == MAX_NEW for t in got)


def test_latency_priority_jumps_bulk_queue(model):
    # 6 bulk clips through a 2-slot pool are 3 admission waves; a
    # latency-class probe submitted after them must not wait for all of them
    cs = clips(6, seed=7, seconds=(3,))
    probe = clips(1, seed=8, seconds=(2,))[0]
    want = solo(model, probe, max_new=1).text
    pool = make_pool(model, slots=2, tick_tokens=2)
    try:
        bulk = [pool.submit(c) for c in cs]
        got = pool.submit(probe, max_new=1, priority="latency").result(timeout=120)
        pending = sum(not f.done() for f in bulk)
        for f in bulk:
            f.result(timeout=120)
    finally:
        pool.close()
    assert got.text == want
    assert pending > 0, "the probe should finish before the bulk queue drains"


def test_submit_rejects_bad_priority(model):
    pool = make_pool(model, slots=1, max_new=2, tick_tokens=2)
    try:
        with pytest.raises(ValueError, match="priority"):
            pool.submit(clips(1)[0], priority="urgent")
    finally:
        pool.close()


def test_staggered_admission_and_slot_reuse(any_model):
    m, admit_batch = any_model
    cs = clips(5, seed=3)
    want = [solo(m, c).text for c in cs]
    pool = make_pool(m, slots=2, tick_tokens=3, admit_batch=admit_batch)
    try:
        first = [pool.submit(c) for c in cs[:2]]
        r0 = first[0].result(timeout=120)
        rest = [pool.submit(c) for c in cs[2:]]   # mid-flight; 5 requests > 2 slots
        got = [r0.text, first[1].result(timeout=120).text] + \
              [f.result(timeout=120).text for f in rest]
    finally:
        pool.close()
    assert got == want


@pytest.mark.parametrize("budget", [1, 3])
def test_budgets_respected(model, budget):
    # a budget of 1: the prefill token is the whole budget, so the slot
    # must not decode in a tick
    c = clips(1, seed=4)[0]
    pool = make_pool(model, slots=1)
    try:
        r_small = pool.submit(c, max_new=budget).result(timeout=120)
        r_big = pool.submit(c, max_new=MAX_NEW).result(timeout=120)
    finally:
        pool.close()
    want_small = solo(model, c, max_new=budget).text
    assert r_small.text == want_small and len(want_small.split()) == budget
    assert r_big.text == solo(model, c).text
    assert r_big.text.startswith(want_small)


def test_forced_eos_stops_early(any_model):
    m, admit_batch = any_model
    c = clips(1, seed=5)[0]
    opts = SamplingOptions(max_tokens=MAX_NEW, force_eos_after=4)
    want = m.transcribe(c, options=opts).text
    pool = make_pool(m, slots=1, options=opts, admit_batch=admit_batch)
    try:
        got = pool.submit(c).result(timeout=120).text
    finally:
        pool.close()
    assert got == want and len(got.split()) == 4


def test_language_prompt_flows_through(model):
    c = clips(1, seed=6)[0]
    pool = make_pool(model, slots=1)
    try:
        got = pool.submit(c, language="en").result(timeout=120)
    finally:
        pool.close()
    assert got.text == solo(model, c, language="en").text
    assert got.language == "en"


def test_overlong_prompt_rejected(model):
    c = clips(1, seed=7, seconds=(9,))[0]   # 16 s bucket: a long prompt
    pool = make_pool(model, slots=1, max_len=64)
    try:
        with pytest.raises(ValueError, match="exceeds pool max_len"):
            pool.submit(c).result(timeout=120)
    finally:
        pool.close()


def test_oversize_fallback_serves_long_clip(model):
    long_c = clips(1, seed=13, seconds=(9,))[0]
    short_c = clips(1, seed=14, seconds=(2,))[0]
    pool = make_pool(model, slots=1, max_len=64, oversize="fallback",
                     options=SamplingOptions(max_tokens=MAX_NEW))
    try:
        f_long, f_short = pool.submit(long_c), pool.submit(short_c)
        got_long = f_long.result(timeout=180).text
        got_short = f_short.result(timeout=180).text
        assert pool.stats["requests_served"] == 2
        assert pool._fb_thread is not None
    finally:
        pool.close()
    assert got_long == solo(model, long_c).text
    assert got_short == solo(model, short_c).text


def test_batched_admission_matches_solo(model):
    """Four same-bucket requests admitted as ONE group (one batched encode,
    one batched prefill, one 4-row insert)."""
    cs = clips(4, seed=11, seconds=(3,))
    want = [solo(model, c).text for c in cs]
    pool = make_pool(model, slots=4, admit_batch=4)
    try:
        reqs = [_Req(c, 16000, None, None, MAX_NEW, Future()) for c in cs]
        for _ in reqs:
            pool._acquire_credit()
        with torch.inference_mode():
            pool._admit_group(reqs)
        got = [r.fut.result(timeout=120).text for r in reqs]
        assert pool.stats["mean_admit_group"] == 4.0
    finally:
        pool.close()
    assert got == want


def test_burst_submission_correct_and_grouped(model):
    cs = clips(6, seed=12, seconds=(3,))
    want = [solo(model, c).text for c in cs]
    pool = make_pool(model, slots=4, admit_batch=4)
    try:
        got = [f.result(timeout=180).text for f in [pool.submit(c) for c in cs]]
        st = pool.stats
        assert st["requests_served"] == 6
        assert 1 <= st["admit_groups"] <= 6
        assert st["tick_ms_p50"] > 0 and st["tick_ms_p90"] >= st["tick_ms_p50"]
    finally:
        pool.close()
    assert got == want


def test_close_never_strands_a_future(model):
    cs = clips(4, seed=15, seconds=(2,))
    pool = make_pool(model, slots=2, max_new=3, tick_tokens=2)
    futs = [pool.submit(c) for c in cs]
    closer = threading.Thread(target=pool.close)
    closer.start()
    outcomes = []
    for f in futs:
        try:
            outcomes.append(bool(f.result(timeout=120).text))
        except RuntimeError as e:
            outcomes.append("closed" in str(e))
    closer.join(timeout=120)
    assert not closer.is_alive()
    assert all(outcomes)
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(cs[0])


def test_concurrent_submitters(model):
    cs = clips(6, seed=8)
    want = [solo(model, c).text for c in cs]
    pool = make_pool(model, slots=3)
    got = [None] * len(cs)
    try:
        def worker(i):
            got[i] = pool.submit(cs[i]).result(timeout=180).text

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(cs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
    finally:
        pool.close()
    assert got == want


def test_rejects_penalties_and_beam(model):
    with pytest.raises(ValueError, match="repetition"):
        SlotPoolASR(model, slots=1, options=SamplingOptions(repetition_penalty=1.2))
    with pytest.raises(ValueError, match="beam"):
        SlotPoolASR(model, slots=1, options=SamplingOptions(beam=2))
    with pytest.raises(ValueError, match="oversize"):
        SlotPoolASR(model, slots=1, oversize="drop")


def test_sampled_pool_draws_from_its_seeded_generators(model):
    """Temperature in the pool: each run seeds the tick thread's generator 0
    and the admission thread's 1, so one clip in a fresh pool draws the
    same tokens every time."""
    c = clips(1, seed=16)[0]
    opts = SamplingOptions(max_tokens=MAX_NEW, temperature=1.0, top_k=20)
    texts = []
    for _ in range(2):
        pool = make_pool(model, slots=2, options=opts)
        try:
            texts.append(pool.submit(c).result(timeout=120).text)
        finally:
            pool.close()
    assert texts[0] == texts[1] and len(texts[0].split()) == MAX_NEW


def test_server_builds_the_port_pool_and_serves_transcribe(model):
    """The port's ``SpeechServer(scheduler="slotpool")`` builds the port's
    pool (the JAX package's server would fall back to its group batcher)
    and routes ``/transcribe`` through it."""
    builder = SpeechServer(build_registry(model), port=0, scheduler="slotpool", max_batch=3)
    built = builder._batcher_for(model)
    try:
        assert isinstance(built, SlotPoolASR) and built.slots == 3
        assert built.oversize == "fallback"
        assert built.max_len == SlotPoolASR.max_len_for(model, builder.slotpool_max_s)
        assert builder._batcher_for(model) is built
    finally:
        built.close()

    srv = SpeechServer(build_registry(model), port=0, scheduler="slotpool", max_batch=2)
    # a small budget so the request decodes 8 tokens, not the server's 448
    srv._batchers[id(model)] = pool = SlotPoolASR(model, slots=2, max_new=8, max_len=512)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        asyncio.run_coroutine_threadsafe(srv.start(), loop).result(timeout=30)
        port = srv._server.sockets[0].getsockname()[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=180)
        try:
            conn.request("POST", "/transcribe", wav_bytes(clips(1, seed=9)[0], 16000),
                         {"Content-Type": "audio/wav"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        assert resp.status == 200 and len(body["text"].split()) == 8
        assert srv._batcher_for(model) is pool and pool.stats["requests_served"] == 1
    finally:
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()
    assert not thread.is_alive()
