"""The Qwen3-ASR decode loop's CUDA-graph path, on the CPU.

A greedy decode on the card captures its second step (``Qwen3ASR._device_step``,
which reads its step index and cache row from device tensors) as a CUDA
graph and replays it for the batch's later steps. Capture needs the card,
so here the captured function runs eagerly in place of each replay, through
the same loop in ``_gen_chunk``; it must equal the host-integer loop bit for
bit: tokens, logprobs, every cache buffer, ``valid``, ``positions``, ``done``
and the cursor. The card tests (``test_torch_cuda.py``) replay real graphs.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu_torch.core import trace
from qwen3_asr_swift_tpu_torch.core.params import init_random_params
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import model as asr_model
from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

CFG = dataclasses.replace(
    config_tiny(), decoder=dataclasses.replace(
        config_tiny().decoder, hidden_size=128, intermediate_size=256, num_heads=4,
        num_kv_heads=2, head_dim=32),
    encoder=dataclasses.replace(config_tiny().encoder, output_dim=128))
#: a token of the random model that rows 0 and 1 emit at steps 10 and 16 and
#: row 2 never (asserted below): as EOS, rows finish at different steps
EOS = 151
MAX_TOKENS = 20
COUNTERS = (trace.GRAPH_CAPTURES, trace.GRAPH_REPLAYS, trace.EAGER_STEPS)


@pytest.fixture(scope="module")
def weights():
    return init_random_params(CFG, seed=0, quant_bits=4)


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(0)
    return [(0.1 * rng.standard_normal(16000 * (1 + i))).astype(np.float32) for i in range(3)]


def run(weights, clips, kv, chunk, force, monkeypatch=None):
    """Decode the clips; with ``monkeypatch``, through the graph path with
    the captured function run eagerly at each replay. Returns (tokens,
    logprobs, the final state, decode steps, counter deltas)."""
    m = Qwen3ASR(dataclasses.replace(CFG, eos_id=EOS), *weights, device="cpu",
                 dtype=torch.bfloat16, kv_dtype=kv, audio_buckets_s=(8,),
                 decode_chunk_tokens=chunk)
    states = []
    gen_chunk = m._gen_chunk

    def record(state, end, opts):
        states.append(state)
        return gen_chunk(state, end, opts)

    m._gen_chunk = record
    if monkeypatch is not None:
        on_card = asr_model.uses_step_graph

        def capture(state, opts, step):
            g = asr_model.StepGraph.at(state, step)
            g.graph = types.SimpleNamespace(replay=lambda: m._device_step(state, opts, g))
            return g

        monkeypatch.setattr(asr_model, "uses_step_graph",
                            lambda dev, *a: on_card(torch.device("cuda"), *a))
        monkeypatch.setattr(m, "_capture", capture)
    before = [c.value for c in COUNTERS]
    tokens, logprobs = m._generate(
        m.prestage(clips), (None, None),
        SamplingOptions(max_tokens=MAX_TOKENS, force_eos_after=force), None,
        torch.Generator().manual_seed(0))
    counts = [c.value - b for c, b in zip(COUNTERS, before)]
    return tokens, logprobs, states[-1], m.last_loop["decode_steps"], counts


def equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("force", [0, 7])
@pytest.mark.parametrize("chunk", [1, 3, 15])
@pytest.mark.parametrize("kv", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_device_step_equals_the_host_loop(weights, clips, monkeypatch, kv, chunk, force):
    want_tok, want_lp, want, steps, eager_counts = run(weights, clips, kv, chunk, force)
    got_tok, got_lp, got, got_steps, graph_counts = run(weights, clips, kv, chunk, force,
                                                        monkeypatch)
    if not force:   # EOS mid-run: rows 0 and 1 stop, row 2 runs to the budget
        first = [int(np.argmax(r == EOS)) if (r == EOS).any() else None
                 for r in want_tok.numpy()]
        assert first == [10, 16, None] and steps == MAX_TOKENS - 1
    assert equal(got_tok, want_tok) and equal(got_lp, want_lp)
    assert equal(got.done, want.done)
    assert equal(got.cache.valid, want.cache.valid)
    assert equal(got.cache.positions, want.cache.positions)
    for lg, lw in zip(got.cache.layers, want.cache.layers):
        for name in ("k", "v", "k_scale", "v_scale"):
            a, b = getattr(lg, name), getattr(lw, name)
            assert (a is None and b is None) or equal(a, b), name
    assert got.cache.cursor == want.cache.cursor and got.step == want.step
    # the device's step and row advanced with the host's
    assert got.graph.step.tolist() == [got.step]
    assert got.graph.cursor.tolist() == [got.cache.cursor]
    assert got_steps == steps
    assert eager_counts == [0, 0, steps]
    assert graph_counts == [0, steps - 1, 1]   # the stand-in capture counts none


SAMPLED = dict(temperature=0.7)


@pytest.mark.parametrize("device,mesh,opts,step,max_new,want", [
    ("cuda", None, {}, 2, 100, True),
    ("cuda", None, dict(force_eos_after=5), 2, 100, True),
    ("cuda", None, {}, 1, 100, False),                      # the warm-up step
    ("cuda", None, {}, 2, 2 + asr_model.GRAPH_MIN_STEPS, True),
    ("cuda", None, {}, 2, 1 + asr_model.GRAPH_MIN_STEPS, False),
    ("cuda", None, {}, 30, 40, True),                       # a later chunk
    ("cpu", None, {}, 2, 100, False),
    ("cuda", object(), {}, 2, 100, False),                  # a dp or tp mesh
    ("cuda", None, dict(temperature=0.7), 2, 100, False),
    ("cuda", None, dict(repetition_penalty=1.1), 2, 100, False),
    ("cuda", None, dict(no_repeat_ngram=3), 2, 100, False),
    ("cuda", None, dict(top_k=5), 2, 100, False),
])
def test_which_steps_take_the_graph(device, mesh, opts, step, max_new, want):
    got = asr_model.uses_step_graph(torch.device(device), mesh, SamplingOptions(**opts), step,
                                    max_new)
    assert got is want


@pytest.mark.parametrize("opts", [{}, dict(temperature=0.7, top_k=5)], ids=["greedy", "sampled"])
def test_eager_steps_count_the_cpu_path(weights, clips, opts):
    m = Qwen3ASR(CFG, *weights, device="cpu", dtype=torch.float32, audio_buckets_s=(8,),
                 decode_chunk_tokens=4)
    before = [c.value for c in COUNTERS]
    m.transcribe_batch(clips, options=SamplingOptions(max_tokens=12, **opts))
    counts = [c.value - b for c, b in zip(COUNTERS, before)]
    assert counts == [0, 0, m.last_loop["decode_steps"]] and counts[2] > 0
    names = trace.counters()
    for c in COUNTERS:
        assert names[c.name] == c.value


def test_held_launches_count_at_each_replay_and_only_this_thread():
    a, b = trace.LaunchCounter("test.held_a"), trace.LaunchCounter("test.held_b")
    other = threading.Barrier(2, timeout=10)

    def elsewhere():
        other.wait()
        a.add(5)
        other.wait()

    t = threading.Thread(target=elsewhere)
    t.start()
    with trace.held_launches() as held:
        a.add()
        b.add(3)
        a.add()
        other.wait()   # the other thread adds while this one holds
        other.wait()
        with trace.held_launches() as inner:
            b.add()
        b.add()
    t.join(timeout=10)
    assert held == {a: 2, b: 4} and inner == {b: 1}
    assert (a.value, b.value) == (5, 0)
    trace.add_held(held)
    trace.add_held(held)
    assert (a.value, b.value) == (9, 8)
    a.add()
    assert a.value == 10
