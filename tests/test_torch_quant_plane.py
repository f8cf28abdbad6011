"""K2's plain version and wrapper, and the ``KERNEL`` selection, against the
JAX package's per-bit-plane Pallas body.

- ``quant_matmul_plane`` and ``quant_matmul_plane_cuda`` (on CPU tensors)
  against ``quant_matmul_pallas(..., interpret=True)`` under
  ``_KERNEL = "plane"``: relative tolerance 1e-5 of max |reference|. Both
  round x, the expanded scale and every code·scale product to bf16 at the
  same places, and a bf16 × bf16 product is exact in fp32, so only the fp32
  summation order differs.
- The same functions against the fp32 ``quant_matmul`` within 2e-2, the
  bound ``tests/test_quant.py`` states for the bf16 planes.

The reference is traced afresh under ``_KERNEL = "plane"`` (its jit cache
does not key on that constant), and a recorder around
``_quant_matmul_kernel`` proves the plane body ran.

For a single activation row the reference's interpret run is not the
plane body's function: XLA on the CPU folds the ``code · scale`` multiply
into the one-row dot and drops its bf16 rounding (a 1-row call differs
from the same row in a 2-row call by ~1e-2). A 1-row case is therefore
held against the reference's 2-row call with the row repeated.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.core.weights import quantize_mlx
from qwen3_asr_swift_tpu.ops import quant as jq
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.ops import quant as pq

PLANE_TOL = 1e-5
FP32_TOL = 2e-2


def make_q(out_dim, in_dim, bits, seed=0, gs=64):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_dim, in_dim)).astype(np.float32) * 0.1
    codes, scales, biases = quantize_mlx(w, bits, gs)
    return {"codes": codes, "scales": scales, "biases": biases}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture
def plane_reference(monkeypatch):
    """``quant_matmul_pallas`` in interpret mode with the plane body; yields
    the list of (bits, repeat) the body was traced with."""
    traced = []
    body = jq._quant_matmul_kernel

    def recorder(*refs, bits, repeat):
        traced.append((bits, repeat))
        return body(*refs, bits=bits, repeat=repeat)

    monkeypatch.setattr(jq, "_KERNEL", "plane")
    monkeypatch.setattr(jq, "_quant_matmul_kernel", recorder)
    jax.clear_caches()
    yield traced
    monkeypatch.undo()
    jax.clear_caches()


def reference(x, p):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if x.shape[0] == 1:
        return np.asarray(jq.quant_matmul_pallas(jnp.asarray(np.repeat(x, 2, axis=0)), jp,
                                                 tile_out=8, interpret=True))[:1]
    return np.asarray(jq.quant_matmul_pallas(jnp.asarray(x), jp, tile_out=8, interpret=True))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("rows", [1, 8, 33])
def test_plane_matches_pallas_plane_body(plane_reference, bits, rows):
    p = make_q(20, 256, bits, seed=10 * bits + rows)   # 20 rows: a ragged last tile
    x = np.random.default_rng(rows).standard_normal((rows, 256)).astype(np.float32)
    ref = reference(x, p)
    assert plane_reference and all(b == bits for b, _ in plane_reference)
    tp = params_from_jax(p, "cpu", torch.float32)
    for fn in (pq.quant_matmul_plane, pq.quant_matmul_plane_cuda):
        got = fn(torch.from_numpy(x), tp).numpy()
        assert got.shape == (rows, 20) and got.dtype == np.float32
        assert rel(got, ref) <= PLANE_TOL
    fp32 = pq.quant_matmul(torch.from_numpy(x), tp).numpy()
    assert rel(got, fp32) <= FP32_TOL
    assert rel(fp32, ref) > PLANE_TOL   # the cases tell the two functions apart


def test_two_bit_group_32_and_leading_dims(plane_reference):
    p = make_q(12, 128, 2, seed=5, gs=32)   # repeat = 32 / 16 = 2
    x = np.random.default_rng(5).standard_normal((2, 3, 128)).astype(np.float32)
    ref = reference(x.reshape(6, 128), p).reshape(2, 3, 12)
    assert plane_reference == [(2, 2)]
    got = pq.quant_matmul_plane_cuda(torch.from_numpy(x), params_from_jax(p, "cpu", torch.float32))
    assert got.shape == (2, 3, 12)
    assert rel(got.numpy(), ref) <= PLANE_TOL


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plane_against_fp32_quant_matmul(bits):
    p = params_from_jax(make_q(96, 192, bits, seed=bits), "cpu", torch.float32)
    x = torch.from_numpy(np.random.default_rng(bits).standard_normal((5, 192)).astype(np.float32))
    fp32 = pq.quant_matmul(x, p).numpy()
    assert rel(pq.quant_matmul_plane(x, p).numpy(), fp32) <= FP32_TOL
    assert rel(pq.quant_matmul_plane_cuda(x, p).numpy(), fp32) <= FP32_TOL


def _routes(monkeypatch, kernel, rows):
    calls = []

    def recorder(name):
        def stub(x, p):
            calls.append(name)
            return torch.zeros((*x.shape[:-1], p["codes"].shape[0]))
        return stub

    for name in ("quant_matmul_cuda", "quant_matmul_plane_cuda", "quant_matmul"):
        monkeypatch.setattr(pq, name, recorder(name))
    monkeypatch.setattr(pq, "KERNEL", kernel)
    p = params_from_jax(make_q(16, 128, 4, seed=1), "cpu", torch.float32)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((rows, 128)).astype(np.float32))
    pq.quant_linear(x, p)
    pq.quant_tied_lm_head(x, p)
    return calls


@pytest.mark.parametrize("kernel,want", [("plane", "quant_matmul_plane_cuda"),
                                         ("fused", "quant_matmul_cuda")])
def test_kernel_selection_routes_decode_shapes(monkeypatch, kernel, want):
    assert _routes(monkeypatch, kernel, 4) == [want, want]
    # above KERNEL_MAX_ROWS both selections take the plain group decomposition
    assert _routes(monkeypatch, kernel, pq.KERNEL_MAX_ROWS + 1) == ["quant_matmul"] * 2


def test_unknown_kernel_raises(monkeypatch):
    with pytest.raises(ValueError, match="QUANT_KERNEL"):
        _routes(monkeypatch, "planar", 4)


def test_kernel_constant_reads_the_environment():
    code = "from qwen3_asr_swift_tpu_torch.ops import quant; print(quant.KERNEL)"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for env, want in (({"QUANT_KERNEL": "plane"}, "plane"), ({}, "fused")):
        base = {k: v for k, v in os.environ.items() if k != "QUANT_KERNEL"}
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=dict(base, **env), cwd=repo, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip() == want
