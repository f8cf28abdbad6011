"""The port's token selection against ``qwen3_asr_swift_tpu/ops/sampling.py``.

The penalties, top-k and top-p are deterministic: on the same seeded
logits and histories they must equal the JAX package's functions exactly.
Temperature draws Gumbel noise from a ``torch.Generator``, which cannot
reproduce ``jax.random``'s bits, so it is held by properties: the same
seed gives the same tokens, draws stay inside the top-k set, and over
20,000 draws the frequencies lie within 0.02 of ``softmax(logits / T)``
(the standard error of a frequency here is at most 0.0036).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.ops import sampling as js
from qwen3_asr_swift_tpu_torch.ops import sampling as ps

V = 64


def case(seed, b=4, length=12, vocab=V):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, vocab)) * 3).astype(np.float32)
    # histories over a small alphabet so tokens and n-grams repeat
    generated = rng.integers(0, 3, size=(b, length)).astype(np.int32)
    gen_len = rng.integers(0, length + 1, size=b).astype(np.int32)
    gen_len[0] = length
    return logits, generated, gen_len


def port(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("seed,penalty", [(0, 1.3), (1, 0.7), (2, 2.0)])
def test_repetition_penalty_equals_reference(seed, penalty):
    logits, gen, glen = case(seed)
    ref = np.asarray(js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(gen),
                                                 jnp.asarray(glen), penalty))
    got = ps.apply_repetition_penalty(port(logits), port(gen), port(glen), penalty).numpy()
    np.testing.assert_array_equal(got, ref)
    # a scalar length broadcasts as in the reference
    ref = np.asarray(js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(gen), 5, penalty))
    got = ps.apply_repetition_penalty(port(logits), port(gen), 5, penalty).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed,n", [(3, 1), (4, 2), (5, 3), (7, 4)])
def test_no_repeat_ngram_equals_reference(seed, n):
    logits, gen, glen = case(seed)
    ref = np.asarray(js.apply_no_repeat_ngram(jnp.asarray(logits), jnp.asarray(gen),
                                              jnp.asarray(glen), n))
    got = ps.apply_no_repeat_ngram(port(logits), port(gen), port(glen), n).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == ps.NEG_INF).any()   # the case masks something


def test_no_repeat_ngram_off_and_scalar_length():
    logits, gen, _ = case(7)
    np.testing.assert_array_equal(
        ps.apply_no_repeat_ngram(port(logits), port(gen), 4, 0).numpy(), logits)
    ref = np.asarray(js.apply_no_repeat_ngram(jnp.asarray(logits), jnp.asarray(gen), 9, 2))
    got = ps.apply_no_repeat_ngram(port(logits), port(gen), 9, 2).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [1, 5, V])
def test_top_k_equals_reference_and_keeps_ties(k):
    logits, _, _ = case(8)
    logits[0, :3] = 9.0   # a three-way tie at the top
    ref = np.asarray(js.apply_top_k(jnp.asarray(logits), k))
    got = ps.apply_top_k(port(logits), k).numpy()
    np.testing.assert_array_equal(got, ref)
    if k == 1:
        assert (got[0] > ps.NEG_INF).sum() == 3   # the tied maxima all survive


@pytest.mark.parametrize("p", [0.3, 0.9, 1.0])
def test_top_p_equals_reference(p):
    logits, _, _ = case(9)
    ref = np.asarray(js.apply_top_p(jnp.asarray(logits), p))
    got = ps.apply_top_p(port(logits), p).numpy()
    np.testing.assert_array_equal(got, ref)


def test_greedy_and_top_k_one_are_argmax():
    logits, gen, glen = case(10)
    want = logits.argmax(-1)
    assert ps.sample_token(port(logits), ps.SamplingOptions()).numpy().tolist() == want.tolist()
    g = torch.Generator().manual_seed(0)
    opts = ps.SamplingOptions(temperature=1.5, top_k=1)
    assert ps.sample_token(port(logits), opts, g).numpy().tolist() == want.tolist()


def test_penalized_greedy_selection_equals_reference():
    logits, gen, glen = case(11)
    for opts in (dict(repetition_penalty=1.5), dict(no_repeat_ngram=2),
                 dict(repetition_penalty=1.2, no_repeat_ngram=3, top_k=7)):
        ref = np.asarray(js.sample_token(jnp.asarray(logits), None, js.SamplingOptions(**opts),
                                         jnp.asarray(gen), jnp.asarray(glen)))
        got = ps.sample_token(port(logits), ps.SamplingOptions(**opts), None, port(gen),
                              port(glen)).numpy()
        np.testing.assert_array_equal(got, ref)


def test_same_seed_same_tokens_and_draws_stay_in_top_k():
    logits, _, _ = case(12, b=16)
    opts = ps.SamplingOptions(temperature=0.9, top_k=5)
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(42)
        draws.append(torch.stack([ps.sample_token(port(logits), opts, g) for _ in range(50)]))
    assert torch.equal(draws[0], draws[1])
    top5 = torch.topk(port(logits), 5, dim=-1).indices
    assert (draws[0][..., None] == top5[None]).any(-1).all()
    with pytest.raises(ValueError, match="Generator"):
        ps.sample_token(port(logits), opts)


def test_temperature_frequencies_follow_softmax():
    rng = np.random.default_rng(13)
    row = rng.standard_normal(8).astype(np.float32)
    temperature = 0.7
    logits = torch.from_numpy(np.tile(row, (20000, 1)))
    g = torch.Generator().manual_seed(3)
    toks = ps.sample_token(logits, ps.SamplingOptions(temperature=temperature), g)
    freq = np.bincount(toks.numpy(), minlength=8) / 20000
    want = torch.softmax(torch.from_numpy(row) / temperature, -1).numpy()
    assert np.abs(freq - want).max() <= 0.02


def test_check_supported_mirrors_the_reference_guards():
    ps.check_supported(ps.SamplingOptions(temperature=0.5, top_k=3, repetition_penalty=1.2))
    ps.check_supported(ps.SamplingOptions(beam=4, length_penalty=0.6))
    with pytest.raises(ValueError, match="requires greedy scoring"):
        ps.check_supported(ps.SamplingOptions(beam=2, top_k=3))
    with pytest.raises(ValueError, match="force_eos_after"):
        ps.check_supported(ps.SamplingOptions(beam=2, force_eos_after=3))
