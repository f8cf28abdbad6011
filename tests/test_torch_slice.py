"""The slice end to end: the port's ``transcribe_batch`` against the JAX
``Qwen3ASR.transcribe_batch`` on the same weights, at the group-64 tiny
config.

Whole token buffers (pads included) and ``n_gen`` must be identical, and
confidences agree within 1e-4. Per-token logprobs agree within 1e-4 with
a dense fp32 decoder; with a packed one the decoder's activations are bf16
in both packages (the packed embedding lookup returns bf16 rows), and a
bf16 rounding that lands the other way moves a logprob by ~1e-3, so they
agree within 1e-2 there. With an int8
KV cache the reference runs its decode attention through the Pallas
kernel in interpret mode — the function the port's K3 implements — instead
of its CPU-only ``sdpa`` over a bf16-dequantized cache.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_asr_swift_tpu.models.qwen3_asr.decoder as jdec
import qwen3_asr_swift_tpu.ops.attention_pallas as jap
from qwen3_asr_swift_tpu.models.qwen3_asr import Qwen3ASR as JaxQwen3ASR
from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jax_tiny
from qwen3_asr_swift_tpu.ops.sampling import SamplingOptions as JaxOptions
from qwen3_asr_swift_tpu_torch.core.params import init_random_params
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions
from qwen3_asr_swift_tpu_torch.serving.dispatch import DispatchGate

MAX_TOKENS = 10


def shrink(cfg):
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))


CFG, JCFG = shrink(config_tiny()), shrink(jax_tiny())


@pytest.fixture(scope="module")
def weights():
    return init_random_params(CFG, seed=0, quant_bits=4)


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(7)
    return [(0.1 * rng.standard_normal(16000)).astype(np.float32),
            (0.1 * rng.standard_normal(41000)).astype(np.float32)]


def capture(model, cls):
    """Record the host buffers each transcribe hands to ``_finalize``."""
    seen = []

    def finalize(tokens, n_gen, logprobs, *rest):
        seen.append((np.array(tokens), np.array(n_gen), np.array(logprobs)))
        return cls._finalize(model, tokens, n_gen, logprobs, *rest)

    model._finalize = finalize
    return seen


def run_jax(weights, clips, qc, kv, wire, monkeypatch, **opts):
    enc, dec = weights
    if kv == "int8":
        monkeypatch.setattr(jdec, "_pallas_attn_ok", lambda: True)
        monkeypatch.setattr(jap, "decode_attention_int8",
                            functools.partial(jap.decode_attention_int8, interpret=True))
    jm = JaxQwen3ASR(JCFG, enc, dec, dtype=jnp.float32, audio_buckets_s=(8,), quant_compute=qc,
                     wire_dtype=wire, kv_dtype=jnp.int8 if kv == "int8" else None)
    seen = capture(jm, JaxQwen3ASR)
    res = jm.transcribe_batch(clips, options=JaxOptions(max_tokens=MAX_TOKENS, **opts))
    monkeypatch.undo()
    return seen[0], res


def port_model(weights, qc, kv, wire, **kw):
    enc, dec = weights
    return Qwen3ASR(CFG, enc, dec, device="cpu", dtype=torch.float32, audio_buckets_s=(8,),
                    quant_compute=qc, wire_dtype=wire,
                    kv_dtype=torch.int8 if kv == "int8" else None, **kw)


def run_port(model, clips, **opts):
    seen = capture(model, Qwen3ASR)
    res = model.transcribe_batch(clips, options=SamplingOptions(max_tokens=MAX_TOKENS, **opts))
    return seen[0], res


def assert_same(port, ref, bf16: bool):
    (pt, pn, plp), (jt, jn, jlp) = port, ref
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_allclose(plp, jlp, atol=1e-2 if bf16 else 1e-4, rtol=0)


@pytest.mark.parametrize("qc,kv,wire", [
    ("packed", "int8", np.float32),
    ("packed", None, np.float32),
    ("dequant", None, np.float32),
    ("packed", "int8", "dpcm4"),
])
def test_tokens_identical_to_reference_chunked_and_monolithic(weights, clips, qc, kv, wire,
                                                              monkeypatch):
    ref, ref_res = run_jax(weights, clips, qc, kv, wire, monkeypatch)
    model = port_model(weights, qc, kv, wire)
    mono, mono_res = run_port(model, clips)
    model.decode_chunk_tokens = 3
    chunked, _ = run_port(model, clips)
    assert_same(mono, ref, bf16=qc == "packed")
    np.testing.assert_array_equal(chunked[0], mono[0])
    np.testing.assert_array_equal(chunked[1], mono[1])
    np.testing.assert_array_equal(chunked[2], mono[2])
    assert [r.text for r in mono_res] == [r.text for r in ref_res]
    assert [r.confidence for r in mono_res] == pytest.approx([r.confidence for r in ref_res], abs=1e-4)


def test_early_eos_pads_and_chunk_exit(weights, clips, monkeypatch):
    """force_eos_after plants an EOS: rows that are done write pads and
    logprob 0, and a chunk boundary after it stops the loop."""
    ref, _ = run_jax(weights, clips, "packed", "int8", np.float32, monkeypatch, force_eos_after=4)
    model = port_model(weights, "packed", "int8", np.float32, decode_chunk_tokens=3)
    got, _ = run_port(model, clips, force_eos_after=4)
    assert_same(got, ref, bf16=True)
    tokens, n_gen, logprobs = got
    assert (tokens[:, 5:] == CFG.pad_id).all() and (logprobs[:, 5:] == 0).all()
    assert (n_gen == 5).all()


def test_dispatch_gate_paths_match_ungated(weights, clips):
    """Gated batch path (encode slot, latency first chunk, bulk chunks) and
    the gated single-clip path (encode + prefill + first chunk in one
    latency slot) give the ungated tokens."""
    plain = port_model(weights, "packed", "int8", np.float32, decode_chunk_tokens=3)
    gated = port_model(weights, "packed", "int8", np.float32, decode_chunk_tokens=3,
                       dispatch_gate=DispatchGate(slots=2), first_chunk_tokens=2)
    for batch in (clips, clips[:1]):
        want, _ = run_port(plain, batch)
        got, _ = run_port(gated, batch)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    stats = gated.dispatch_gate.stats
    assert stats["latency"]["acquired"] >= 2 and stats["bulk"]["acquired"] >= 3
    timings = {}  # a timed single clip takes the gated batch path, encode slot included
    gated.transcribe_batch(clips[:1], max_tokens=3, timings=timings)
    assert timings["encode"] > 0 and gated.dispatch_gate.stats["bulk"]["acquired"] > stats["bulk"]["acquired"]


def test_timings_and_memory_stats(weights, clips):
    model = port_model(weights, "packed", "int8", "mulaw")
    timings = {}
    res = model.transcribe_batch(clips, max_tokens=3, timings=timings)
    assert set(timings) == {"host_prep", "encode", "generate", "postprocess"}
    assert len(res) == 2 and all(r.text for r in res)
    assert model.memory_stats().parameter_bytes > 0
    model.warm_up(max_tokens=2)
    assert model.is_loaded
    with pytest.raises(ValueError, match="requires greedy scoring"):
        model.transcribe_batch(clips, options=SamplingOptions(max_tokens=3, temperature=0.7,
                                                              beam=2))
    with pytest.raises(ValueError, match="unknown quant_compute"):
        port_model(weights, "int4", None, np.float32)
