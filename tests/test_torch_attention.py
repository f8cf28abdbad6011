"""K3's plain version, ``sdpa`` and the static KV cache against the JAX package.

K3 tolerance: 1e-5 relative to max |reference| — the plain version, the
Pallas kernel in interpret mode, ``sdpa`` over the dequantized cache and
``k3_emulate`` (the CUDA kernel's split-and-merge arithmetic) are all fp32
and differ only in summation order and where the scales multiply in.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.ops import attention as ja
from qwen3_asr_swift_tpu.ops import kv_cache as jkv
from qwen3_asr_swift_tpu.ops.attention_pallas import decode_attention_int8 as jax_k3
from qwen3_asr_swift_tpu_torch.ops import attention as pa
from qwen3_asr_swift_tpu_torch.ops import attention_int8 as pk3
from qwen3_asr_swift_tpu_torch.ops import kv_cache as pkv

K3_TOL = 1e-5


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def k3_inputs(seed, b=2, hq=4, hkv=2, length=37, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, length, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, length, d)).astype(np.float32)
    valid = rng.random((b, length)) > 0.3
    valid[:, 0] = True
    kq, ks = jkv._quantize(jnp.asarray(k))
    vq, vs = jkv._quantize(jnp.asarray(v))
    return q, np.array(kq), np.array(ks), np.array(vq), np.array(vs), valid


@pytest.mark.parametrize("seed,length", [(0, 37), (1, 130), (2, 5)])
def test_k3_plain_matches_pallas_interpret_and_sdpa(seed, length):
    """GQA group 2, L not a multiple of 128, holes in ``valid``."""
    q, kq, ks, vq, vs, valid = k3_inputs(seed, length=length)
    d = q.shape[-1]
    interp = np.asarray(jax_k3(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
                               jnp.asarray(vs), jnp.asarray(valid), interpret=True))
    kd = kq.astype(np.float32) * ks[..., None]
    vd = vq.astype(np.float32) * vs[..., None]
    mask = np.where(valid, 0.0, ja.NEG_INF).astype(np.float32)[:, None, None, :]
    via_sdpa = np.asarray(ja.sdpa(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd),
                                  1.0 / np.sqrt(d), jnp.asarray(mask)))
    t = torch.from_numpy
    got = pk3.decode_attention_int8(t(q), t(kq), t(ks), t(vq), t(vs), t(valid)).numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    assert rel(got, interp) <= K3_TOL
    assert rel(got, via_sdpa) <= K3_TOL


def test_k3_plain_bf16_query():
    q, kq, ks, vq, vs, valid = k3_inputs(3)
    t = torch.from_numpy
    q16 = t(q).to(torch.bfloat16)
    got = pk3.decode_attention_int8(q16, t(kq), t(ks), t(vq), t(vs), t(valid))
    ref = pk3.decode_attention_int8_ref(q16.float(), t(kq), t(ks), t(vq), t(vs), t(valid))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def k3_emulate(q, kq, ks, vq, vs, valid, split):
    """K3's arithmetic on the CPU (``csrc/decode_attn_int8.cu``): L cut
    into splits of ``split`` keys (the last ragged); each split's exact
    softmax gives (m, l, acc) in fp32, acc = Σ_j p_j·vs_j·v_j; the splits
    merge in split order, acc_s·e^(m_s-M) over l_s·e^(m_s-M), M = max m_s;
    one split writes acc / l."""
    b, hq, _, d = q.shape
    hkv, length = kq.shape[1], kq.shape[2]
    qg = q[:, :, 0].float().reshape(b, hkv, hq // hkv, d)
    parts = []
    for j0 in range(0, length, split):
        j = slice(j0, min(length, j0 + split))
        s = torch.matmul(qg, kq[:, :, j].float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
        s = s * ks[:, :, None, j]
        s = torch.where(valid[:, None, None, j], s, torch.full_like(s, pk3.NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        acc = torch.matmul(p * vs[:, :, None, j], vq[:, :, j].float())
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    if len(parts) == 1:
        _, l, acc = parts[0]
        return (acc / l).reshape(b, hq, 1, d)
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        c = torch.exp(m - mx)
        num = num + acc * c
        den = den + l * c
    return (num / den).reshape(b, hq, 1, d)


def _masked(valid, case):
    valid = valid.copy()
    if case == "split_masked":      # keys 8..15 masked in row 0, valid keys elsewhere
        valid[0, 8:16] = False
    elif case == "row_masked":      # row 1 has no valid key: the uniform average
        valid[1, :] = False
    return valid


@pytest.mark.parametrize("case,length,split", [
    ("ragged", 37, 8),              # 5 splits, the last of 5 keys
    ("split_masked", 40, 8),
    ("row_masked", 128, 48),        # L a multiple of 128: the Pallas kernel pads no key
    ("short", 5, 16),               # L below one split: no merge
    ("one_key", 1, 16),
    ("default", 580, None),         # the slice's L under the kernel's own split
])
def test_k3_split_merge_matches_plain_and_pallas_interpret(case, length, split):
    q, kq, ks, vq, vs, valid = k3_inputs(7, length=length, d=32 if split else 128)
    valid = _masked(valid, case)
    if split is None:
        split = pk3.split_keys(length, q.shape[-1])
        assert 1 < split < length
    t = torch.from_numpy
    got = k3_emulate(t(q), t(kq), t(ks), t(vq), t(vs), t(valid), split)
    plain = pk3.decode_attention_int8_ref(t(q), t(kq), t(ks), t(vq), t(vs), t(valid))
    interp = np.asarray(jax_k3(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
                               jnp.asarray(vs), jnp.asarray(valid), interpret=True))
    assert torch.isfinite(got).all()
    assert rel(got.numpy(), plain.numpy()) <= K3_TOL
    assert rel(got.numpy(), interp) <= K3_TOL
    if case == "row_masked":
        d = q.shape[-1]
        uniform = (vq[1].astype(np.float32) * vs[1][..., None]).mean(axis=1)   # [Hkv, D]
        want = np.repeat(uniform, q.shape[1] // kq.shape[1], axis=0)[:, None]   # [Hq, 1, D]
        assert rel(got[1].numpy(), want) <= K3_TOL and want.shape == (q.shape[1], 1, d)


@pytest.mark.parametrize("length,d", [(1, 128), (64, 128), (65, 128), (580, 128), (580, 64),
                                      (4096, 256), (37, 32)])
def test_k3_split_keys_cover_l_evenly(length, d):
    split = pk3.split_keys(length, d)
    n_split = -(-length // split)
    assert 1 <= split <= length and (n_split - 1) * split < length <= n_split * split
    assert 2 * d * split <= max(pk3.SPLIT_BYTES, 2 * d)          # a block reads at most this
    assert n_split == -(-length // max(1, pk3.SPLIT_BYTES // (2 * d)))   # the fewest splits


def test_k3_plain_bf16_output_is_the_rounded_fp32_output():
    q, kq, ks, vq, vs, valid = k3_inputs(8, length=50)
    t = torch.from_numpy
    q16 = t(q).to(torch.bfloat16)
    args = (q16, t(kq), t(ks), t(vq), t(vs), t(valid))
    got = pk3.decode_attention_int8(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, pk3.decode_attention_int8_ref(*args).to(torch.bfloat16))


def test_k3_checks_reject_bad_inputs():
    q, kq, ks, vq, vs, valid = k3_inputs(4, d=32)
    t = torch.from_numpy
    with pytest.raises(TypeError):
        pk3._check(t(q), t(kq).float(), t(ks), t(vq), t(vs), t(valid))
    with pytest.raises(ValueError):
        pk3._check(t(q), t(kq), t(ks), t(vq), t(vs), t(valid).to(torch.uint8))
    with pytest.raises(ValueError):
        pk3._check(t(q)[:, :3], t(kq), t(ks), t(vq), t(vs), t(valid))
    pk3._check(t(q), t(kq), t(ks), t(vq), t(vs), t(valid))


@pytest.mark.parametrize("tq,causal", [(1, False), (9, True)])
def test_sdpa_matches_reference(tq, causal):
    rng = np.random.default_rng(5)
    b, hq, hkv, tk, d = 2, 6, 2, 9, 8
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, tk, d)).astype(np.float32)
    valid = rng.random((b, tk)) > 0.2
    valid[:, 0] = True
    ok = valid[:, None, None, :]
    if causal:
        ok = ok & (np.arange(tk)[None, :] <= np.arange(tq)[:, None])[None, None]
    mask = np.where(ok, 0.0, ja.NEG_INF).astype(np.float32)
    ref = np.asarray(ja.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, jnp.asarray(mask)))
    got = pa.sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0.3,
                  torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_int8_quantize_rounds_half_to_even():
    # max |x| = 127 → scale 1, so x/scale hits exact .5 ties
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.0], np.float32).reshape(1, 1, 1, 8)
    jq, js = jkv._quantize(jnp.asarray(x))
    pq, ps = pkv.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert pq.numpy().ravel().tolist() == [127, 0, 2, 2, 0, -2, -2, 3]


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_cache_writes_and_bookkeeping_match_reference(dtype):
    rng = np.random.default_rng(6)
    b, hkv, max_len, d, t = 2, 2, 12, 8, 5
    jdt, pdt = (jnp.int8, torch.int8) if dtype == "int8" else (jnp.float32, torch.float32)
    jc = jkv.init_cache(1, b, hkv, max_len, d, jdt)
    pc = pkv.init_cache(1, b, hkv, max_len, d, pdt, "cpu")
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    valid = np.array([[1, 1, 0, 1, 1], [1, 0, 0, 1, 1]], bool)
    jl = jkv.write_prompt(jc.layers[0], jnp.asarray(k), jnp.asarray(v))
    jc = jkv.after_prefill(jc, [jl], jnp.asarray(valid), t)
    pkv.write_prompt(pc.layers[0], torch.from_numpy(k), torch.from_numpy(v))
    pkv.after_prefill(pc, torch.from_numpy(valid), t)
    k1 = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
    jl = jkv.write_token(jc.layers[0], jnp.asarray(k1), jnp.asarray(k1), jc.cursor)
    jc = jkv.after_token(jc, [jl])
    pkv.write_token(pc.layers[0], torch.from_numpy(k1), torch.from_numpy(k1), pc.cursor)
    pkv.after_token(pc)
    assert pc.cursor == int(jc.cursor) == t + 1
    np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(jc.valid))
    np.testing.assert_array_equal(pc.positions.numpy(), np.asarray(jc.positions))
    for name in ("k", "v", "k_scale", "v_scale"):
        ref = getattr(jc.layers[0], name)
        if ref is None:
            assert getattr(pc.layers[0], name) is None
            continue
        np.testing.assert_array_equal(getattr(pc.layers[0], name).numpy(), np.asarray(ref))
    jk, jv = jkv.cache_kv(jc.layers[0], jnp.float32)
    pk, pv = pkv.cache_kv(pc.layers[0], torch.float32)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
