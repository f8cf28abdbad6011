"""The port's tracer (``core/trace.py``) and the spans of the Qwen3-ASR
batch path, on the CPU at the group-64 tiny config of
``tests/test_torch_slice.py``:

- off, a span site records nothing and gets one shared object;
- on, the tokens and logprobs are those of a run with it off, and each
  ``transcribe_batch`` records one ``asr.batch`` tree: a step a decode
  step with its decoder and sampling, a ``done`` read a chunk boundary;
- ``to_trace_ns`` puts a span inside the ``torch.profiler`` range around
  it (``profile_trace``'s spans are held in ``tests/test_torch_surface.py``);
- the launch counters, two threads, the cap;
- the batchers' mean queue waits, and the gate's waits left to its stats;
- the readings of ``scripts/torch_trace_breakdown.py`` on synthetic spans
  and a synthetic profile.
"""

import dataclasses
import importlib.util
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu_torch.core import trace
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.ops import cuda_build
from qwen3_asr_swift_tpu_torch.ops.attention_int8 import K3_LAUNCHES
from qwen3_asr_swift_tpu_torch.ops.quant import K1_LAUNCHES, K2_LAUNCHES
from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions
from qwen3_asr_swift_tpu_torch.serving.batching import ContinuousBatcher, TTSBatcher
from qwen3_asr_swift_tpu_torch.serving.dispatch import BULK, LATENCY, DispatchGate

REPO = Path(__file__).resolve().parent.parent
MAX_TOKENS, CHUNK = 10, 3


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    yield
    trace.disable()


def tiny_cfg():
    cfg = config_tiny()
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))


@pytest.fixture(scope="module")
def model():
    return Qwen3ASR.init_random(tiny_cfg(), seed=0, device="cpu", dtype=torch.float32,
                                quant_bits=4, kv_dtype=torch.int8, audio_buckets_s=(8,),
                                decode_chunk_tokens=CHUNK)


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(7)
    return [(0.1 * rng.standard_normal(16000)).astype(np.float32),
            (0.1 * rng.standard_normal(41000)).astype(np.float32)]


def transcribe(model, clips, **opts):
    """(tokens, n_gen, logprobs) that ``_finalize`` receives, and the results."""
    seen = []

    def finalize(tokens, n_gen, logprobs, *rest):
        seen.append((np.array(tokens), np.array(n_gen), np.array(logprobs)))
        return Qwen3ASR._finalize(model, tokens, n_gen, logprobs, *rest)

    model._finalize = finalize
    try:
        res = model.transcribe_batch(clips, options=SamplingOptions(max_tokens=MAX_TOKENS,
                                                                    **opts))
    finally:
        del model._finalize
    return seen[0], res


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_returns_one_object(model, clips):
    before = trace.spans()   # what an earlier session left, readable after disable()
    first = trace.span("asr.step")
    assert first is trace.OFF and trace.span("asr.batch") is first
    with first as s:
        assert s is first
    transcribe(model, clips)
    assert trace.spans() == before and not trace.ON


# ---------------------------------------------------------------------------
# on: the same tokens, and the tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opts", [{}, {"force_eos_after": 4}])
def test_tracing_changes_no_token(model, clips, opts):
    off, off_res = transcribe(model, clips, **opts)
    trace.enable()
    on, on_res = transcribe(model, clips, **opts)
    trace.disable()
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert [r.text for r in on_res] == [r.text for r in off_res]
    assert trace.spans()


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_a_batch_records_one_tree(model, clips):
    trace.enable()
    done_reads = []
    model._all_done = lambda state: done_reads.append(1) or Qwen3ASR._all_done(state)
    try:
        transcribe(model, clips)
    finally:
        del model._all_done
    trace.disable()
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["asr.batch"]
    root = roots[0]
    steps = model.last_loop["decode_steps"]
    assert steps == MAX_TOKENS - 1
    top = [s.name for s in children(spans, root)]
    assert top == (["asr.prestage", "asr.encode", "asr.prefill", "asr.decode_chunk"]
                   + ["asr.done_read", "asr.decode_chunk"] * 2 + ["asr.fetch", "asr.finalize"])
    assert top.count("asr.done_read") == len(done_reads) == 2
    chunks = [s for s in spans if s.name == "asr.decode_chunk"]
    assert [len(children(spans, c)) for c in chunks] == [CHUNK] * 3
    step_spans = [s for s in spans if s.name == "asr.step"]
    assert len(step_spans) == steps
    for st in step_spans:
        assert by_id[st.parent].name == "asr.decode_chunk"
        assert [c.name for c in children(spans, st)] == ["asr.decoder", "asr.sample"]
    for s in spans:
        assert s.batch == root.id and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s.name
    assert {s.name for s in spans} == {
        "asr.batch", "asr.prestage", "asr.encode", "asr.prefill", "asr.decode_chunk",
        "asr.step", "asr.decoder", "asr.sample", "asr.done_read", "asr.fetch", "asr.finalize"}


def test_each_batch_is_a_root_of_its_own(model, clips):
    trace.enable()
    transcribe(model, clips[:1])
    transcribe(model, clips)
    spans = trace.spans()
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["asr.batch"] * 2
    assert len({r.batch for r in roots}) == 2
    assert roots[0].end_ns <= roots[1].start_ns
    for r in roots:
        assert sum(s.batch == r.id and s.name == "asr.step" for s in spans) == MAX_TOKENS - 1
    assert all(r.id == r.batch for r in roots)


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------

def test_to_trace_ns_puts_a_span_inside_the_profiler_range():
    """Each span lies inside the range opened around it, each end within
    1 ms of the range's (a profile's first range costs more: the
    benchmark's window opens with a range of its own, as this one does)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("opener"):
            pass
        for i in range(5):
            with record_function(f"outer{i}"):
                with trace.span(f"inner{i}"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                    time.sleep(0.002)
    trace.disable()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("outer")}
    heads, tails = [], []
    for s in trace.spans():
        r0, r1 = ranges["outer" + s.name[len("inner"):]]
        t0, t1 = trace.to_trace_ns(s)
        assert r0 <= t0 <= t1 <= r1, s.name
        heads.append(t0 - r0)
        tails.append(r1 - t1)
    assert len(heads) == 5
    assert max(heads) < 1_000_000 and max(tails) < 1_000_000, (heads, tails)


# ---------------------------------------------------------------------------
# counters, threads, the cap
# ---------------------------------------------------------------------------

def test_launch_counters_count_and_are_named():
    assert cuda_build.LaunchCounter is trace.LaunchCounter
    names = trace.counters()
    for c in (K1_LAUNCHES, K2_LAUNCHES, K3_LAUNCHES):
        assert names[c.name] == c.value
    base = K1_LAUNCHES.value, K3_LAUNCHES.value
    K1_LAUNCHES.add()
    K3_LAUNCHES.add(3)
    K1_LAUNCHES.add()
    assert (K1_LAUNCHES.value, K3_LAUNCHES.value) == (base[0] + 2, base[1] + 3)
    names = trace.counters()
    assert (names[K1_LAUNCHES.name], names[K3_LAUNCHES.name]) == (base[0] + 2, base[1] + 3)


def test_two_threads_keep_their_own_parents():
    trace.enable()
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with trace.span(f"root.{tag}"):
            for i in range(20):
                barrier.wait()
                with trace.span(f"step.{tag}"):
                    with trace.span(f"leaf.{tag}"):
                        barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    trace.disable()
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    assert len(spans) == 2 * 41
    for s in spans:
        tag = s.name.split(".")[1]
        assert by_id[s.batch].name == f"root.{tag}"
        if s.parent is not None:
            assert by_id[s.parent].name.endswith(tag)
            want = {"step": "root", "leaf": "step"}[s.name.split(".")[0]]
            assert by_id[s.parent].name == f"{want}.{tag}"


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    trace.enable()
    with trace.span("root"):
        for _ in range(7):
            with trace.span("s"):
                pass
    assert len(trace.spans()) == 5 and trace.dropped() == 3
    trace.enable()
    assert trace.spans() == [] and trace.dropped() == 0


def test_a_tree_opened_before_enable_is_not_kept():
    trace.enable()
    with trace.span("old"):
        trace.enable()   # clears the records and the anchors
        with trace.span("child"):
            pass
        with trace.span("old.child"):
            pass
    with trace.span("new"):
        pass
    assert [s.name for s in trace.spans()] == ["new"]
    trace.to_trace_ns(trace.spans()[0])


def test_no_profiler_range_unless_annotating():
    """Recording alone puts nothing into a profiler's trace; annotating
    puts each span in as a range."""
    from torch.profiler import ProfilerActivity, profile

    def ranges(annotate):
        trace.enable(annotate=annotate)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("asr.batch"):
                with trace.span("asr.step"):
                    torch.ones(8, 8) @ torch.ones(8, 8)
        trace.disable()
        assert [s.name for s in trace.spans()] == ["asr.batch", "asr.step"]
        return {e.name() for e in prof.profiler.kineto_results.events()}

    assert not {"asr.batch", "asr.step"} & ranges(False)
    assert {"asr.batch", "asr.step"} <= ranges(True)


# ---------------------------------------------------------------------------
# serving waits
# ---------------------------------------------------------------------------

class _SlowASR:
    dispatch_gate = None

    def transcribe_batch(self, audios, sample_rate=16000, **kw):
        time.sleep(0.05)
        return [SimpleNamespace(text=str(len(a))) for a in audios]


def test_batcher_mean_queue_wait_ms():
    """One worker, batches of one, 50 ms a batch: the three requests wait
    about 0, 50 and 100 ms."""
    b = ContinuousBatcher(_SlowASR(), max_batch=1, max_wait_ms=1, workers=1, gate_slots=0)
    try:
        futs = [b.submit(np.zeros(n, np.float32)) for n in (10, 20, 30)]
        assert [f.result(timeout=10).text for f in futs] == ["10", "20", "30"]
        stats = b.stats
    finally:
        b.shutdown()
    assert stats["requests_served"] == 3
    assert 45 < stats["mean_queue_wait_ms"] < 1000


def test_tts_batcher_mean_queue_wait_ms():
    class SlowTTS:
        def synthesize(self, text, **kw):
            time.sleep(0.05)
            return text.upper()

    b = TTSBatcher(SlowTTS(), max_batch=1, max_wait_ms=1, workers=1)
    try:
        futs = [b.submit(t) for t in ("a", "b")]
        assert [f.result(timeout=10) for f in futs] == ["A", "B"]
        stats = b.stats
    finally:
        b.shutdown()
    assert stats["requests_served"] == 2
    assert 20 < stats["mean_queue_wait_ms"] < 1000


def test_gate_waits_stay_in_its_stats():
    """The gate's waits are its per-lane ``stats``, as in the original; a
    wait records no span."""
    gate = DispatchGate(slots=1)
    trace.enable()
    gate.acquire(BULK)
    waiter = threading.Thread(target=lambda: (gate.acquire(LATENCY), gate.release()))
    waiter.start()
    time.sleep(0.03)
    gate.release()
    waiter.join(timeout=10)
    assert not waiter.is_alive()
    trace.disable()
    assert trace.spans() == []
    assert gate.stats["bulk"]["acquired"] == 1
    assert gate.stats["latency"]["acquired"] == 1 and gate.stats["latency"]["mean_wait_ms"] > 20


# ---------------------------------------------------------------------------
# the breakdown's readings
# ---------------------------------------------------------------------------

def breakdown():
    spec = importlib.util.spec_from_file_location(
        "torch_trace_breakdown", REPO / "scripts" / "torch_trace_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthetic_batch(first_id, t0, steps, step_ns, sample_ns, done_ns, fetch_ns):
    """The spans of one batch starting at ``t0`` ns: prestage, then steps of
    ``step_ns`` with a sample of ``sample_ns``, a done read after each 2
    steps, then the fetch."""
    ids = iter(range(first_id, first_id + 10_000))
    root = next(ids)
    out, t = [], t0
    out.append(trace.Span(next(ids), root, root, "asr.prestage", t, t + 1000))
    t += 1000
    for i in range(steps):
        sid = next(ids)
        out.append(trace.Span(sid, root, root, "asr.step", t, t + step_ns))
        out.append(trace.Span(next(ids), sid, root, "asr.sample", t + step_ns - sample_ns,
                              t + step_ns))
        t += step_ns
        if i % 2 == 1:
            out.append(trace.Span(next(ids), root, root, "asr.done_read", t, t + done_ns))
            t += done_ns
    out.append(trace.Span(next(ids), root, root, "asr.fetch", t, t + fetch_ns))
    t += fetch_ns
    out.append(trace.Span(root, None, root, "asr.batch", t0, t))
    return sorted(out, key=lambda s: s.start_ns), t


def test_breakdown_host_readings():
    bd = breakdown()
    a, t = synthetic_batch(1, 0, 4, 10_000_000, 2_000_000, 3_000_000, 5_000_000)
    b, t = synthetic_batch(100, t, 2, 20_000_000, 1_000_000, 1_000_000, 1_000_000)
    c, _ = synthetic_batch(200, t, 2, 1, 1, 1, 1)   # the profiled batch: not read
    spans = a + b + c
    assert bd.decode_dispatch_ms(spans, 2) == pytest.approx((40 + 40) / 6)
    assert bd.decode_sample_ms(spans, 2) == pytest.approx((8 + 2) / 6)
    assert bd.sync_wait_ms(spans, 2) == pytest.approx(((6 + 5) + (1 + 1)) / 2)
    assert bd.sync_wait_ms(spans, 2, ("asr.fetch",)) == pytest.approx((5 + 1) / 2)
    assert bd.decode_dispatch_ms(spans, 0) is None and bd.sync_wait_ms([], 1) is None


def test_breakdown_idle_in_dispatch():
    bd = breakdown()
    spans, _ = synthetic_batch(1, 0, 2, 10_000_000, 1_000_000, 2_000_000, 1_000_000)
    anchors = {1: (5_000_000_000, 0)}   # the root's (time_ns, perf_counter_ns)
    to_trace = lambda s: tuple(anchors[s.batch][0] + t for t in (s.start_ns, s.end_ns))  # noqa
    us = lambda ns: 5_000_000 + ns / 1e3  # noqa: E731  perf ns → the profile's µs
    # perf ns: prestage 0..1000, steps 1000..10_001_000..20_001_000, a done read to
    # 22_001_000, the fetch to 23_001_000
    profile = {
        "window": (us(0), us(24_001_000)),
        "host_ranges": [(us(0), us(24_001_000), "(window)"), (us(-100), us(1100), "prestage")],
        "kernels": [("k", us(2_001_000), us(3_001_000)),      # gap 2.001 ms from the prestage
                    ("k", us(6_001_000), us(9_001_000)),      # gap 3 ms, starts in step 1
                    ("k", us(12_001_000), us(21_001_000)),    # gap 3 ms, starts in step 1
                    ("k", us(21_501_000), us(23_001_000))],   # gap 0.5 ms, in the done read
    }
    # and the window's tail, 1 ms from the end of the fetch
    got = bd.idle_in_dispatch(spans, 0, profile, to_trace)
    assert got == pytest.approx(100 * 6 / (2.001 + 3 + 3 + 0.5 + 1))
    late = dict(profile, host_ranges=[(us(-100), us(900), "prestage")])   # prestage ends past it
    assert bd.idle_in_dispatch(spans, 0, late, to_trace) is None
    far = dict(profile, host_ranges=[(us(-100), us(2_500_000), "prestage")])   # 2.5 ms later
    assert bd.idle_in_dispatch(spans, 0, far, to_trace) is None
    assert bd.idle_in_dispatch(spans, 0, dict(profile, host_ranges=[]), to_trace) is None
    by_span = bd.idle_by_span(spans, 0, profile, to_trace)
    assert list(by_span) == ["asr.step", "asr.sample", "asr.prestage", "outside the ranges",
                             "asr.done_read"]
    assert [round(v * 1e3, 6) for v in by_span.values()] == [3, 3, 2.001, 1, 0.5]
