"""The port's nn primitives and RoPE against the JAX package, in fp32.

Tolerance 1e-5 relative (1e-6 absolute): the same fp32 math, summed in
another order by another BLAS.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.ops import nn as jnn
from qwen3_asr_swift_tpu.ops import rope as jrope
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.ops import nn as pnn
from qwen3_asr_swift_tpu_torch.ops import rope as prope

RNG = np.random.default_rng(0)


def close(got, ref, rtol=1e-5, atol=1e-6):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=rtol, atol=atol)


def arr(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def test_rope_angles_and_apply():
    pos = np.array([[0, 1, 5, 17], [3, 3, 400, 9]], np.int32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), 32, 1e6)
    pc, ps = prope.rope_angles(torch.from_numpy(pos), 32, 1e6)
    close(pc, jc)
    close(ps, js)
    x = arr(2, 3, 4, 32)
    ref = jrope.apply_rope(jnp.asarray(x), jc[:, None], js[:, None])
    got = prope.apply_rope(torch.from_numpy(x), pc[:, None], ps[:, None])
    close(got, ref)
    close(got, jrope.rope_reference(x, pos[:, None], 1e6), rtol=1e-4, atol=1e-5)


def test_norms_and_activations():
    x, w, b = arr(3, 5, 64), arr(64), arr(64)
    t = torch.from_numpy
    close(pnn.rms_norm(t(x), t(w), 1e-6), jnn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    close(pnn.layer_norm(t(x), t(w), t(b), 1e-5),
          jnn.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    close(pnn.gelu(t(x)), jnn.gelu(jnp.asarray(x)))
    close(pnn.silu(t(x)), jnn.silu(jnp.asarray(x)))


def test_rms_norm_keeps_bf16():
    x = torch.from_numpy(arr(2, 64)).to(torch.bfloat16)
    assert pnn.rms_norm(x, torch.ones(64), 1e-6).dtype == torch.bfloat16


@pytest.mark.parametrize("bias", [False, True])
def test_linear_dense(bias):
    x = arr(2, 7, 48)
    p = {"kernel": arr(48, 20)}
    if bias:
        p["bias"] = arr(20)
    ref = jnn.linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    close(pnn.linear(torch.from_numpy(x), params_from_jax(p, "cpu", torch.float32)), ref)


def test_linear_bf16_rows_into_fp32_kernel():
    """bf16 activations (from a packed embedding) into an fp32 kernel:
    computed in fp32, returned in bf16, as the reference's dot_general."""
    x = jnp.asarray(arr(4, 48)).astype(jnp.bfloat16)
    p = {"kernel": arr(48, 16)}
    ref = jnn.linear(x, {"kernel": jnp.asarray(p["kernel"])})
    got = pnn.linear(torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16),
                     params_from_jax(p, "cpu", torch.float32))
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(ref.astype(jnp.float32)), rtol=1e-2, atol=1e-2)


def test_swiglu_fused_and_unfused():
    x = arr(3, 32)
    mlp = {"gate_proj": {"kernel": arr(32, 24)}, "up_proj": {"kernel": arr(32, 24)},
           "down_proj": {"kernel": arr(24, 32)}}
    ref = jnn.swiglu_mlp(jnp.asarray(x), {k: {"kernel": jnp.asarray(v["kernel"])} for k, v in mlp.items()})
    tmlp = params_from_jax(mlp, "cpu", torch.float32)
    close(pnn.swiglu_mlp(torch.from_numpy(x), tmlp), ref)
    fused = pnn.fuse_qkv_gate_up({"layers": [{"mlp": tmlp}]})["layers"][0]["mlp"]
    assert set(fused) == {"gate_up_proj", "down_proj"}
    close(pnn.swiglu_mlp(torch.from_numpy(x), fused), ref)


def test_fuse_qkv_matches_reference_layout():
    layer = {n: {"kernel": arr(16, o)} for n, o in (("q_proj", 32), ("k_proj", 16), ("v_proj", 16))}
    layer["mlp"] = {"gate_proj": {"kernel": arr(16, 8)}, "up_proj": {"kernel": arr(16, 8)},
                    "down_proj": {"kernel": arr(8, 16)}}
    ref = jnn.fuse_qkv_gate_up({"layers": [layer]})["layers"][0]
    got = pnn.fuse_qkv_gate_up({"layers": [params_from_jax(layer, "cpu", torch.float32)]})["layers"][0]
    close(got["qkv_proj"]["kernel"], ref["qkv_proj"]["kernel"], rtol=0, atol=0)
    close(got["mlp"]["gate_up_proj"]["kernel"], ref["mlp"]["gate_up_proj"]["kernel"], rtol=0, atol=0)


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
def test_conv2d_nhwc_hwio(stride):
    x = arr(2, 9, 7, 3)
    p = {"kernel": arr(3, 3, 3, 5), "bias": arr(5)}
    ref = jnn.conv2d(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, stride=stride)
    got = pnn.conv2d(torch.from_numpy(x), params_from_jax(p, "cpu", torch.float32), stride=stride)
    assert tuple(got.shape) == ref.shape
    close(got, ref)


def test_embedding_and_dense_tied_head():
    table, ids, h = arr(50, 16), np.array([[1, 4], [49, 0]], np.int32), arr(3, 16)
    close(pnn.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids)),
          jnn.embedding_lookup(jnp.asarray(table), jnp.asarray(ids)), rtol=0, atol=0)
    close(pnn.tied_lm_head(torch.from_numpy(h), torch.from_numpy(table)),
          jnn.tied_lm_head(jnp.asarray(h), jnp.asarray(table)))
