"""K1's plain version and the quantized ops of the port against the JAX package.

Tolerances (relative to max |reference|):
- 1e-5 against ``quant_matmul_xla``: both are fp32 group decompositions,
  differing in summation order and in where the group scale multiplies;
  kernel K1's arithmetic (emulated here in torch, since its CUDA source
  runs only on the card) is held to the same;
- 2e-2 against the Pallas kernel in interpret mode, which rounds its
  dequantized planes and x to bf16 (as tests/test_quant.py states).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.core.weights import quantize_mlx
from qwen3_asr_swift_tpu.ops import quant as jq
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax, quantize_tree_np
from qwen3_asr_swift_tpu_torch.ops import quant as pq

XLA_TOL = 1e-5
PALLAS_TOL = 2e-2


def make_q(out_dim, in_dim, bits, seed=0, bias=False, gs=64):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_dim, in_dim)).astype(np.float32) * 0.1
    codes, scales, biases = quantize_mlx(w, bits, gs)
    p = {"codes": codes, "scales": scales, "biases": biases}
    if bias:
        p["bias"] = rng.standard_normal(out_dim).astype(np.float32)
    return p


def to_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def to_port(p):
    return params_from_jax(p, "cpu", torch.float32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plain_matches_xla(bits):
    p = make_q(96, 192, bits, seed=bits)
    x = np.random.default_rng(1).standard_normal((5, 192)).astype(np.float32)
    ref = np.asarray(jq.quant_matmul_xla(jnp.asarray(x), to_jax(p)))
    got = pq.quant_matmul(torch.from_numpy(x), to_port(p)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert rel(got, ref) <= XLA_TOL


@pytest.mark.parametrize("bits", [4, 8])
def test_wrapper_on_cpu_matches_pallas_interpret_and_xla(bits):
    p = make_q(16, 128, bits, seed=10 + bits)
    x = np.random.default_rng(2).standard_normal((8, 128)).astype(np.float32)
    y_pallas = np.asarray(jq.quant_matmul_pallas(jnp.asarray(x), to_jax(p), tile_out=8,
                                                 interpret=True))
    y_xla = np.asarray(jq.quant_matmul_xla(jnp.asarray(x), to_jax(p)))
    got = pq.quant_matmul_cuda(torch.from_numpy(x), to_port(p)).numpy()
    assert rel(got, y_pallas) <= PALLAS_TOL
    assert rel(got, y_xla) <= XLA_TOL


def test_ragged_out_dim_and_leading_dims():
    p = make_q(12, 128, 4, seed=3)   # 12 output rows: not a tile multiple
    x = np.random.default_rng(3).standard_normal((2, 3, 128)).astype(np.float32)
    y_pallas = np.asarray(jq.quant_matmul_pallas(jnp.asarray(x), to_jax(p), tile_out=8,
                                                 interpret=True))
    y_xla = np.asarray(jq.quant_matmul_xla(jnp.asarray(x), to_jax(p)))
    got = pq.quant_matmul_cuda(torch.from_numpy(x), to_port(p)).numpy()
    assert got.shape == (2, 3, 12)
    assert rel(got, y_xla) <= XLA_TOL
    assert rel(got, y_pallas) <= PALLAS_TOL


@pytest.mark.parametrize("rows", [4, 300])
def test_quant_linear_with_bias_both_row_regimes(rows):
    """≤256 rows go through the K1 wrapper, more through the plain
    decomposition (chunked) — the same row rule as the reference."""
    p = make_q(64, 128, 4, seed=4, bias=True)
    x = np.random.default_rng(4).standard_normal((rows, 128)).astype(np.float32)
    ref = np.asarray(jq.quant_linear(jnp.asarray(x), to_jax(p)))
    got = pq.quant_linear(torch.from_numpy(x), to_port(p)).numpy()
    assert rel(got, ref) <= XLA_TOL


@pytest.mark.parametrize("bits", [2, 8])
def test_plain_matches_explicit_group_sums(bits):
    """Folding the scale into the codes equals the per-group partial sums
    Σ_g s·(x_g·c_g) + Σ_g β·Σx_g, computed here in float64."""
    p = make_q(24, 256, bits, seed=20 + bits)
    x = np.random.default_rng(5).standard_normal((7, 256))
    codes = np.asarray(jq.unpack_codes(jnp.asarray(p["codes"]), bits, 256), np.float64)
    xg, cg = x.reshape(7, 4, 64), codes.reshape(24, 4, 64)
    partial = np.einsum("bgi,ogi->bgo", xg, cg)
    ref = np.einsum("bgo,og->bo", partial, p["scales"]) + xg.sum(-1) @ p["biases"].T
    got = pq.quant_matmul(torch.from_numpy(x.astype(np.float32)), to_port(p)).numpy()
    assert rel(got, ref) <= XLA_TOL


def test_codes_keep_their_bits_as_int32_view():
    p = make_q(8, 128, 4, seed=6)
    p["codes"][0, 0] = np.uint32(0xFFFFFFFF)  # sign bit set: every nibble 15
    tp = to_port(p)
    assert tp["codes"].dtype == torch.int32
    assert np.array_equal(tp["codes"].numpy().view(np.uint32), p["codes"])
    got = pq.unpack_codes(tp["codes"], 4, 128).numpy()
    ref = np.asarray(jq.unpack_codes(jnp.asarray(p["codes"]), 4, 128))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_embedding_lookup(bits):
    p = make_q(40, 128, bits, seed=7)
    ids = np.array([[0, 5, 39], [7, 7, 1]], np.int32)
    ref = np.asarray(jq.quant_embedding_lookup(to_jax(p), jnp.asarray(ids), 128,
                                               dtype=jnp.float32))
    got = pq.quant_embedding_lookup(to_port(p), torch.from_numpy(ids), 128,
                                    dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # default dtype: bf16 rows, as the reference returns them
    assert pq.quant_embedding_lookup(to_port(p), torch.from_numpy(ids), 128).dtype == torch.bfloat16


def test_quant_tied_lm_head():
    p = make_q(300, 128, 4, seed=8)
    h = np.random.default_rng(8).standard_normal((3, 128)).astype(np.float32)
    ref = np.asarray(jq.quant_tied_lm_head(jnp.asarray(h), to_jax(p)))
    got = pq.quant_tied_lm_head(torch.from_numpy(h), to_port(p)).numpy()
    assert got.dtype == np.float32
    assert rel(got, ref) <= XLA_TOL


def test_dequantize_tree_and_quantize_tree_match_reference():
    rng = np.random.default_rng(9)
    tree = {"embed_tokens": rng.standard_normal((64, 128)).astype(np.float32),
            "layers": [{"proj": {"kernel": rng.standard_normal((128, 192)).astype(np.float32),
                                 "bias": np.zeros(192, np.float32)},
                        "small": {"kernel": rng.standard_normal((128, 8)).astype(np.float32)}}]}
    qt_port = quantize_tree_np(tree, 4)
    qt_ref = jq.quantize_tree(tree, 4)
    for key in ("codes", "scales", "biases"):
        np.testing.assert_array_equal(qt_port["layers"][0]["proj"][key],
                                      qt_ref["layers"][0]["proj"][key])
        np.testing.assert_array_equal(qt_port["embed_tokens"][key], qt_ref["embed_tokens"][key])
    assert "kernel" in qt_port["layers"][0]["small"]  # too narrow: stays dense

    ref = jq.dequantize_tree(jax.tree_util.tree_map(jnp.asarray, qt_ref), 4, 64, jnp.float32)
    got = pq.dequantize_tree(params_from_jax(qt_port, "cpu", torch.float32), 4, 64, torch.float32)
    np.testing.assert_allclose(got["embed_tokens"].numpy(), np.asarray(ref["embed_tokens"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["layers"][0]["proj"]["kernel"].numpy(),
                               np.asarray(ref["layers"][0]["proj"]["kernel"]), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="packing mismatch"):
        pq.dequantize_tree(params_from_jax(qt_port, "cpu", torch.float32), 8, 64)


def test_infer_quant_dims_rejects_bad_shapes():
    with pytest.raises(ValueError):
        pq.infer_quant_dims(100, (4, 10), (4, 2))


# --------------------------------------------------------------------------- #
# Kernel K1's arithmetic (csrc/quant_matmul.cu), emulated in torch

#: bf16 terms K1 cuts fp32 x into. Two terms (hi + lo) leave up to 2^-16 of
#: each activation, and the code·x group sums are several times larger than
#: y (the bias term cancels their offset): up to 2.9e-5 of max |y| over the
#: cases below, above the 1e-5 tolerance. Three terms hold every normal
#: fp32 value exactly (1.95e-6 over the same cases: fp32 sum order alone).
K1_TERMS = 3


def k1_terms(x32: torch.Tensor, n: int):
    """fp32 x as n bf16 terms, as K1 cuts them: each term is the top half
    of the bits of what the terms before it left."""
    terms, rest = [], x32.clone()
    for _ in range(n):
        t = (rest.view(torch.int32) & -65536).view(torch.float32)
        terms.append(t)
        rest = rest - t
    return terms


def k1_emulate(x: torch.Tensor, p, n_terms: int) -> torch.Tensor:
    """K1's decomposition of x [B, in] (fp32, or bf16 as one term): each
    group's sum of code·x over the terms (exact products, summed in
    float64 and rounded once to fp32, as the tensor cores' fp32 sums
    approximate), times the group's fp32 scale, plus its bias times the
    fp32 sum of the group's x, taken in group order in fp32."""
    in_dim = x.shape[-1]
    bits, gs = pq.infer_quant_dims(in_dim, p["codes"].shape, p["scales"].shape)
    xf = x.float()
    rows, groups = xf.shape[0], in_dim // gs
    codes = pq.unpack_codes(p["codes"], bits, in_dim).view(-1, groups, gs).double()
    partial = sum(torch.einsum("bgi,ogi->bgo", t.view(rows, groups, gs).double(), codes)
                  for t in k1_terms(xf, n_terms)).float()                   # [B, G, out]
    xsum = xf.view(rows, groups, gs).sum(-1)                                 # [B, G]
    y = torch.zeros(rows, codes.shape[0])
    for g in range(groups):
        y = y + p["scales"][:, g] * partial[:, g]
        y = y + p["biases"][:, g] * xsum[:, g, None]
    return y


def test_k1_three_bf16_terms_hold_fp32_exactly():
    """Three terms, each exact in bf16, sum back to any normal fp32 value;
    two leave a remainder."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal(20000).astype(np.float32) * np.exp2(
        rng.integers(-60, 60, 20000)).astype(np.float32)
    terms = k1_terms(torch.from_numpy(x), K1_TERMS)
    for t in terms:
        assert torch.equal(t, t.to(torch.bfloat16).float())
    assert torch.equal(terms[0] + terms[1] + terms[2], torch.from_numpy(x))
    assert not torch.equal(terms[0] + terms[1], torch.from_numpy(x))


@pytest.mark.parametrize("rows", [1, 7, 33])
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_k1_decomposition_matches_plain_and_xla(bits, gs, rows):
    """K1's arithmetic against the plain version and the reference's
    ``quant_matmul_xla``, for every packing K1 takes, with fp32 x in
    K1_TERMS bf16 terms and with bf16 x as it is."""
    p = make_q(40, 256, bits, seed=bits * 1000 + gs + rows, gs=gs)
    x = np.random.default_rng(rows + gs).standard_normal((rows, 256)).astype(np.float32)
    for xt, n_terms in ((torch.from_numpy(x), K1_TERMS),
                        (torch.from_numpy(x).to(torch.bfloat16), 1)):
        xs = xt.float().numpy()
        got = k1_emulate(xt, to_port(p), n_terms).numpy()
        assert rel(got, pq.quant_matmul(torch.from_numpy(xs), to_port(p)).numpy()) <= XLA_TOL
        assert rel(got, np.asarray(jq.quant_matmul_xla(jnp.asarray(xs), to_jax(p)))) <= XLA_TOL
