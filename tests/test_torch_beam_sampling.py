"""Beam search and the penalty options: the port's ``transcribe_batch``
against the JAX package's on the same weights, at the group-64 tiny config
of ``tests/test_torch_slice.py``.

Token buffers (pads included) and ``n_gen`` must be identical. With an
int8 KV cache the reference runs its decode attention through the Pallas
kernel in interpret mode, the function the port's K3 implements.
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
    rng = np.random.default_rng(11)
    return [(0.1 * rng.standard_normal(16000)).astype(np.float32),
            (0.1 * rng.standard_normal(37000)).astype(np.float32)]


def capture(model, cls):
    """Record the host buffers each transcribe hands to ``_finalize``."""
    seen = []

    def finalize(tokens, n_gen, logprobs, *rest):
        seen.append((np.array(tokens), np.array(n_gen), np.array(logprobs)))
        return cls._finalize(model, tokens, n_gen, logprobs, *rest)

    model._finalize = finalize
    return seen


def run_jax(weights, clips, qc, kv, monkeypatch, **opts):
    enc, dec = weights
    if kv == "int8":
        monkeypatch.setattr(jdec, "_pallas_attn_ok", lambda: True)
        monkeypatch.setattr(jap, "decode_attention_int8",
                            functools.partial(jap.decode_attention_int8, interpret=True))
    jm = JaxQwen3ASR(JCFG, enc, dec, dtype=jnp.float32, audio_buckets_s=(8,), quant_compute=qc,
                     kv_dtype=jnp.int8 if kv == "int8" else None)
    seen = capture(jm, JaxQwen3ASR)
    jm.transcribe_batch(clips, options=JaxOptions(max_tokens=MAX_TOKENS, **opts))
    monkeypatch.undo()
    return seen[0]


def port_model(weights, qc, kv, **kw):
    enc, dec = weights
    return Qwen3ASR(CFG, enc, dec, device="cpu", dtype=torch.float32, audio_buckets_s=(8,),
                    quant_compute=qc, kv_dtype=torch.int8 if kv == "int8" else None, **kw)


def run_port(model, clips, **opts):
    seen = capture(model, Qwen3ASR)
    res = model.transcribe_batch(clips, options=SamplingOptions(max_tokens=MAX_TOKENS, **opts))
    return seen[0], res


def assert_tokens_equal(port, ref):
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])


@pytest.mark.parametrize("qc,kv", [("dequant", None), ("packed", None), ("packed", "int8")])
def test_beam_tokens_identical_to_reference(weights, clips, qc, kv, monkeypatch):
    ref = run_jax(weights, clips, qc, kv, monkeypatch, beam=3)
    got, res = run_port(port_model(weights, qc, kv), clips, beam=3)
    assert_tokens_equal(got, ref)
    # the output contract of the greedy path: n_gen counts the non-pad tokens
    assert (got[1] == (got[0] != CFG.pad_id).sum(axis=1)).all() and (got[1] > 0).all()
    np.testing.assert_allclose(got[2], ref[2], atol=1e-2 if qc == "packed" else 1e-4, rtol=0)
    assert len(res) == 2


def test_beam_under_a_dispatch_gate_rides_the_latency_lane(weights, clips):
    plain = port_model(weights, "packed", "int8")
    gated = port_model(weights, "packed", "int8", dispatch_gate=DispatchGate(slots=2))
    want, _ = run_port(plain, clips[:1], beam=2, length_penalty=0.6)
    got, _ = run_port(gated, clips[:1], beam=2, length_penalty=0.6)
    assert_tokens_equal(got, want)
    stats = gated.dispatch_gate.stats
    assert stats["latency"]["acquired"] >= 2   # the encode of one clip and the search


def test_penalties_tokens_identical_to_reference(weights, clips, monkeypatch):
    opts = dict(repetition_penalty=1.3, no_repeat_ngram=2)
    ref = run_jax(weights, clips, "packed", "int8", monkeypatch, **opts)
    model = port_model(weights, "packed", "int8", decode_chunk_tokens=4)
    got, _ = run_port(model, clips, **opts)
    assert_tokens_equal(got, ref)
    # no bigram repeats within a row's emitted tokens
    for row, n in zip(got[0], got[1]):
        grams = list(zip(row[:n - 1], row[1:n]))
        assert len(grams) == len(set(grams))


def test_beam_guards_raise_the_reference_errors(weights, clips):
    model = port_model(weights, "packed", None)
    with pytest.raises(ValueError, match="requires greedy scoring"):
        model.transcribe_batch(clips, options=SamplingOptions(max_tokens=3, beam=2,
                                                              temperature=0.5))
    with pytest.raises(ValueError, match="force_eos_after"):
        model.transcribe_batch(clips, options=SamplingOptions(max_tokens=3, beam=2,
                                                              force_eos_after=1))


def test_sampled_decode_is_seeded(weights, clips):
    model = port_model(weights, "packed", "int8", decode_chunk_tokens=3)
    opts = dict(temperature=0.8, top_k=50, repetition_penalty=1.1, no_repeat_ngram=3)
    a, _ = run_port(model, clips, **opts)
    b, _ = run_port(model, clips, **opts)
    assert_tokens_equal(a, b)
    seen = capture(model, Qwen3ASR)
    model.transcribe_batch(clips, options=SamplingOptions(max_tokens=MAX_TOKENS, **opts), seed=5)
    assert not np.array_equal(seen[0][0], a[0]), "another seed should draw other tokens"
