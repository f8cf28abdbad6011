"""``quant_compute="groupdot"`` against the JAX package.

- ``quant_matmul_groupdot`` within 1e-5 of max |reference| at 2, 4 and 8
  bits (8 bits recentres its codes by -128): the integer partials are
  exact in both packages, so only fp32 sums of the scaled partials differ;
- the repacked tree (int8 codes ``[G, gs, out]``, fp32 scales and biases
  ``[G, out]``) equals the reference's, leaf for leaf; the embedding stays
  packed;
- ``linear`` takes the group-dot layout, bias included;
- under group-dot the LM head is the only product that reaches kernel K1's
  wrapper;
- every group-dot product of the port's model, prefill and decode,
  equals the reference's function on the same input (1e-5);
- with the products teacher-forced (each answered by the reference's
  output for that call), everything between them equals the reference
  within 1e-5, float and int8 KV, and each decode step's greedy token is
  the reference's. Whole-model tokens are not held against the
  reference's, see ``test_groupdot_decoder_matches_reference_call_by_call``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.qwen3_asr import Qwen3ASR as JaxQwen3ASR
from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jax_tiny
from qwen3_asr_swift_tpu.ops import nn as jnn
from qwen3_asr_swift_tpu.ops import quant as jq
from qwen3_asr_swift_tpu_torch.core.params import init_random_params, params_from_jax
from qwen3_asr_swift_tpu_torch.core.weights import dequantize_mlx, quantize_mlx
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import decoder as pdec
from qwen3_asr_swift_tpu_torch.ops import nn as pnn
from qwen3_asr_swift_tpu_torch.ops import quant as pq


def shrink(cfg):
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))


CFG, JCFG = shrink(config_tiny()), shrink(jax_tiny())


def packed(out_dim, in_dim, bits, group=64, seed=0, bias=False):
    w = np.random.default_rng(seed).standard_normal((out_dim, in_dim)).astype(np.float32)
    codes, scales, biases = quantize_mlx(w, bits, group)
    p = {"codes": codes, "scales": scales, "biases": biases}
    if bias:
        p["bias"] = np.random.default_rng(seed + 1).standard_normal(out_dim).astype(np.float32)
    return p


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_groupdot_matmul_matches_reference(bits):
    p = packed(48, 384, bits, seed=bits)
    x = np.random.default_rng(10 + bits).standard_normal((7, 384)).astype(np.float32)
    x[0, :64] = 0.0   # an all-zero group: sx falls back to 1e-12/127
    want = np.asarray(jq.quant_matmul_groupdot(jnp.asarray(x), jq.repack_groupdot(p)))
    gp = pq.repack_groupdot(params_from_jax(p, "cpu", torch.float32), 64)
    got = pq.quant_matmul_groupdot(torch.from_numpy(x), gp).numpy()
    assert got.shape == want.shape == (7, 48)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


@pytest.mark.parametrize("bits,group", [(2, 32), (4, 32), (8, 32), (2, 128), (4, 128), (8, 128)])
def test_groupdot_other_group_sizes_given_the_group(bits, group):
    """The group size is the caller's: at group 32 or 128 the packed shapes
    can also read as another packing (4-bit group 32 has the shapes of
    2-bit group 64), and the reference's guess, 64 first, misreads those.
    The repacked codes dequantize to the packed weight exactly, and the
    product equals a float64 evaluation of the group-dot function within
    1e-5."""
    p = packed(48, 384, bits, group, seed=bits)
    gp = pq.repack_groupdot(params_from_jax(p, "cpu", torch.float32), group)
    g, gs, out = gp["gcodes"].shape
    assert (g, gs) == (384 // group, group)
    dense = (gp["gcodes"].float() * gp["gscales"][:, None] + gp["gbiases"][:, None]).reshape(-1, out)
    w = pq.dequantize(params_from_jax(p, "cpu", torch.float32), 384)
    torch.testing.assert_close(dense.T, w, rtol=0, atol=1e-5)
    x = np.random.default_rng(3).standard_normal((5, 384)).astype(np.float32)
    xg = x.reshape(5, g, gs)
    sx = np.maximum(np.abs(xg).max(-1), 1e-12).astype(np.float32) / np.float32(127)
    xq = np.clip(np.round(xg / sx[..., None]), -127, 127)
    partial = np.einsum("bgk,gko->bgo", xq, gp["gcodes"].numpy().astype(np.float64))
    truth = (np.einsum("bgo,bg,go->bo", partial, sx.astype(np.float64),
                       gp["gscales"].double().numpy())
             + xg.sum(-1, dtype=np.float64) @ gp["gbiases"].double().numpy())
    got = pq.quant_matmul_groupdot(torch.from_numpy(x), gp).double().numpy()
    assert np.abs(got - truth).max() / np.abs(truth).max() <= 1e-5
    misread = jq.repack_groupdot(p)["gcodes"].shape[:2] != (384 // group, group)
    assert misread == ((bits, group) in ((4, 32), (8, 32), (2, 128), (4, 128)))


def test_groupdot_partials_are_exact_integers():
    """One group of extreme values: |Σ xq·code| = 64·127·128 < 2^24 is
    summed exactly in fp32."""
    p = params_from_jax(packed(8, 64, 8, seed=3), "cpu", torch.float32)
    gp = pq.repack_groupdot(p, 64)
    gp["gcodes"] = torch.full_like(gp["gcodes"], -128)
    gp["gscales"] = torch.ones_like(gp["gscales"])
    gp["gbiases"] = torch.zeros_like(gp["gbiases"])
    y = pq.quant_matmul_groupdot(torch.full((1, 64), 3.0), gp)
    sx = np.float32(3.0) / np.float32(127.0)
    assert (y.numpy() == np.float32(-64 * 127 * 128) * sx).all()


def _tree():
    return {"layers": [{"q_proj": packed(64, 128, 4, seed=1),
                        "mlp": {"down_proj": packed(128, 256, 8, seed=2, bias=True)}},
                       {"q_proj": packed(64, 128, 2, seed=3)}],
            "embed_tokens": packed(96, 128, 4, seed=4)}


def test_repacked_tree_equals_reference():
    want = jq.cast_tree(jq.repack_tree_groupdot(_tree()), jnp.float32)
    got = pq.repack_tree_groupdot(params_from_jax(_tree(), "cpu", torch.float32), 64)
    assert "codes" in got["embed_tokens"] and "gcodes" in got["layers"][0]["q_proj"]

    def walk(g, w, path):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), path
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, (list, tuple)):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}[{i}]")
        else:
            w = np.asarray(w)
            if w.dtype == np.uint32:          # packed codes: the port keeps an int32 view
                w = w.view(np.int32)
            assert g.numpy().dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)

    walk(got, want, "tree")


def test_params_from_jax_keeps_the_groupdot_layout():
    gp = jq.repack_groupdot(packed(16, 128, 4, bias=True))
    got = params_from_jax(gp, "cpu", torch.bfloat16)
    assert got["gcodes"].dtype == torch.int8
    assert got["gscales"].dtype == got["gbiases"].dtype == torch.float32
    assert got["bias"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_dispatches_groupdot(dtype):
    p = packed(32, 128, 4, seed=5, bias=True)
    x = np.random.default_rng(6).standard_normal((3, 128)).astype(np.float32)
    want = np.asarray(jnn.linear(jnp.asarray(x, dtype), jq.cast_tree(jq.repack_groupdot(p),
                                                                      getattr(jnp, dtype))))
    gp = pq.repack_groupdot(params_from_jax(p, "cpu", getattr(torch, dtype)), 64)
    got = pnn.linear(torch.from_numpy(x).to(getattr(torch, dtype)), gp)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert np.abs(got - want.astype(np.float32)).max() / np.abs(want.astype(np.float32)).max() <= tol


@pytest.fixture(scope="module")
def weights():
    return init_random_params(CFG, seed=0, quant_bits=4)


def test_only_the_lm_head_reaches_k1_under_groupdot(weights, monkeypatch):
    model = Qwen3ASR(CFG, *weights, device="cpu", dtype=torch.float32, audio_buckets_s=(8,),
                     quant_compute="groupdot", kv_dtype=torch.int8)
    calls = []
    real = pq.quant_matmul_cuda
    monkeypatch.setattr(pq, "quant_matmul_cuda", lambda x, p: calls.append(x.shape) or real(x, p))
    cache = pdec.make_cache(CFG.decoder, 2, 16, torch.int8, device="cpu")
    pdec.decode_step(model.decoder_params, CFG.decoder, torch.tensor([1, 2]), cache)
    assert calls == [(2, CFG.decoder.hidden_size)]


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(7)
    return [(0.1 * rng.standard_normal(16000)).astype(np.float32),
            (0.1 * rng.standard_normal(41000)).astype(np.float32)]


def test_groupdot_decoder_matches_reference_call_by_call(weights, clips):
    """Every group-dot product the port's model computes (prefill, and
    decode steps over an int8 cache) equals the reference's function on the
    same input, within 1e-5 of max |reference|.

    Whole-model outputs cannot be held token for token: the int8
    activation quantizer is discontinuous, and the two packages' inputs to
    it differ by rounding noise (bf16 roundings after the packed
    embedding, fp32 sums taken in another order, and up to 1e-4 of the
    encoder's output). Now and then an input crosses a rounding boundary,
    each such flip moves a product by up to sx·scale, and the nearly flat
    logits of a random tiny model then pick another token at a near-tie.
    ``test_groupdot_decoder_teacher_forced_matches_reference`` holds what
    lies between the products."""
    enc, dec = weights
    model = Qwen3ASR(CFG, enc, dec, device="cpu", dtype=torch.float32, audio_buckets_s=(8,),
                     quant_compute="groupdot", kv_dtype=torch.int8)
    jm = JaxQwen3ASR(JCFG, enc, dec, dtype=jnp.float32, audio_buckets_s=(8,),
                     quant_compute="groupdot")
    ref_params = {}

    def index(node, jnode, path=""):
        if isinstance(node, dict):
            if "gcodes" in node:
                ref_params[id(node["gcodes"])] = (path, jnode)
                return
            for k in node:
                index(node[k], jnode[k], f"{path}.{k}")
        elif isinstance(node, list):
            for i, (a, b) in enumerate(zip(node, jnode)):
                index(a, b, f"{path}[{i}]")

    index(model.decoder_params, jm.decoder_params)
    calls = []
    real = pq.quant_matmul_groupdot

    def record(x, p):
        y = real(x, p)
        calls.append((x.clone(), y.clone(), ref_params[id(p["gcodes"])]))
        return y

    pq.quant_matmul_groupdot = record
    try:
        model.transcribe_batch(clips, max_tokens=3)
    finally:
        pq.quant_matmul_groupdot = real
    layers = CFG.decoder.num_layers
    # q, o, gate_up, down per layer (k/v stay dense at this width), for the
    # prefill and 2 decode steps
    assert len(calls) == 3 * layers * 4
    for x, y, (path, jp) in calls:
        want = np.asarray(jq.quant_matmul_groupdot(jnp.asarray(x.float().numpy()), jp))
        got = y.numpy()
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5, path


def test_groupdot_transcribe_chunked_equals_monolithic(weights, clips):
    enc, dec = weights
    model = Qwen3ASR(CFG, enc, dec, device="cpu", dtype=torch.float32, audio_buckets_s=(8,),
                     quant_compute="groupdot", kv_dtype=torch.int8)
    seen = []
    finalize = model._finalize

    def capture(tokens, n_gen, *rest):
        seen.append((np.array(tokens), np.array(n_gen)))
        return finalize(tokens, n_gen, *rest)

    model._finalize = capture
    model.transcribe_batch(clips, max_tokens=10)
    model.decode_chunk_tokens = 3
    model.transcribe_batch(clips, max_tokens=10)
    (mono, n_mono), (chunked, n_chunked) = seen
    assert (n_mono > 0).all()
    np.testing.assert_array_equal(chunked, mono)
    np.testing.assert_array_equal(n_chunked, n_mono)


def quantizer_input(x, group_size):
    """x / sx per (row, group): the values the group-dot activation
    quantizer rounds to int8 codes."""
    xg = x.reshape(-1, x.shape[-1] // group_size, group_size).astype(np.float32)
    sx = np.maximum(np.abs(xg).max(-1), np.float32(1e-12)) / np.float32(127)
    return xg / sx[..., None]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_groupdot_decoder_teacher_forced_matches_reference(weights, kv, monkeypatch):
    """Everything between the group-dot products, held against the
    reference under group-dot: norms, rope, attention (the int8-KV decode
    too), residuals, the MLP's wiring, the LM head.

    Both decoders take the same prompt embeddings (with padding holes) and
    the same tokens. The reference records each product's input and
    output; the port runs with each product answered by the reference's
    output for that call, after its own input to the product is held to
    the reference's on the valid rows (1e-5 of max |input|). The prefill's
    hidden states and each decode step's logits then agree within 1e-5 and
    each step's greedy token is the reference's. Where the two inputs of a
    product round to different int8 activation codes, the reference's
    value lies within 1e-3 of a rounding boundary: left to its own
    products, the port differs from the reference only by quantizer flips
    at near-ties. Each product alone is held by
    ``test_groupdot_decoder_matches_reference_call_by_call``.

    The embedding table is dequantized to fp32 here: a packed table's rows
    come out bf16 in both packages, and the bf16 elementwise ops after it
    round differently (one bf16 ulp), which would hide a wiring fault
    behind 2^-8 of noise."""
    import qwen3_asr_swift_tpu.models.qwen3_asr.decoder as jdec
    import qwen3_asr_swift_tpu.ops.attention_pallas as jap

    if kv == "int8":
        # the reference's own int8 decode semantics (its Pallas kernel in
        # interpret mode), which the port's K3 implements
        monkeypatch.setattr(jdec, "_pallas_attn_ok", lambda: True)
        monkeypatch.setattr(jap, "decode_attention_int8",
                            functools.partial(jap.decode_attention_int8, interpret=True))
    enc, dec = weights
    table = dec["embed_tokens"]
    dec = {**dec, "embed_tokens": dequantize_mlx(np.asarray(table["codes"]), table["scales"],
                                                 table["biases"], 4, 64)}
    pm = Qwen3ASR(CFG, enc, dec, device="cpu", dtype=torch.float32, audio_buckets_s=(8,),
                  quant_compute="groupdot")
    jm = JaxQwen3ASR(JCFG, enc, dec, dtype=jnp.float32, audio_buckets_s=(8,),
                     quant_compute="groupdot")
    rng = np.random.default_rng(11)
    t, steps = 48, 4
    embeds = (0.5 * rng.standard_normal((2, t, CFG.decoder.hidden_size))).astype(np.float32)
    valid = np.ones((2, t), bool)
    valid[1, 12:20] = False     # padded audio rows
    valid[0, t - 5:] = False    # padded suffix rows

    ref = []
    real_j = jq.quant_matmul_groupdot

    def record(x, p):
        y = real_j(x, p)
        ref.append((np.asarray(x), np.asarray(y)))
        return y

    monkeypatch.setattr(jq, "quant_matmul_groupdot", record)
    jcache = jdec.make_cache(JCFG.decoder, 2, t + steps, getattr(jnp, kv))
    want_h, jcache = jdec.prefill(jm.decoder_params, JCFG.decoder, jnp.asarray(embeds),
                                  jnp.asarray(valid), jcache)
    want_logits, ids = [], [np.array([5, 300], np.int32)]
    for _ in range(steps):
        logits, jcache = jdec.decode_step(jm.decoder_params, JCFG.decoder, jnp.asarray(ids[-1]),
                                          jcache)
        want_logits.append(np.asarray(logits))
        ids.append(want_logits[-1].argmax(-1).astype(np.int32))

    calls, flips, gaps = iter(ref), [], []

    def oracle(x, p):
        rx, ry = next(calls)
        gx = x.float().numpy()
        assert gx.shape == rx.shape and ry.shape[-1] == p["gcodes"].shape[-1]
        rows = valid.reshape(-1) if gx.shape[:2] == valid.shape else np.ones(2, bool)
        gx, rx = gx.reshape(-1, gx.shape[-1])[rows], rx.reshape(-1, rx.shape[-1])[rows]
        gaps.append(np.abs(gx - rx).max() / np.abs(rx).max())
        v_ref, v_got = (quantizer_input(a, p["gcodes"].shape[1]) for a in (rx, gx))
        moved = np.round(v_ref) != np.round(v_got)
        flips.extend(np.abs(np.abs(v_ref[moved] - np.trunc(v_ref[moved])) - 0.5))
        return torch.from_numpy(ry.copy())

    monkeypatch.setattr(pq, "quant_matmul_groupdot", oracle)
    pcache = pdec.make_cache(CFG.decoder, 2, t + steps, getattr(torch, kv), device="cpu")
    got_h, pcache = pdec.prefill(pm.decoder_params, CFG.decoder, torch.from_numpy(embeds),
                                 torch.from_numpy(valid), pcache)
    got_logits = []
    for step in range(steps):
        logits, pcache = pdec.decode_step(pm.decoder_params, CFG.decoder,
                                          torch.from_numpy(ids[step]).long(), pcache)
        got_logits.append(logits.numpy())
    assert next(calls, None) is None
    assert len(gaps) == len(ref) == (1 + steps) * 4 * CFG.decoder.num_layers
    assert max(gaps) <= 1e-5, " ".join(f"{g:.2g}" for g in gaps)
    assert all(d <= 1e-3 for d in flips), flips
    mask = valid[..., None]
    h, wh = got_h.numpy() * mask, np.asarray(want_h) * mask
    assert np.abs(h - wh).max() / np.abs(wh).max() <= 1e-5
    for step, (g, w) in enumerate(zip(got_logits, want_logits)):
        assert np.abs(g - w).max() / np.abs(w).max() <= 1e-5, step
        np.testing.assert_array_equal(g.argmax(-1), ids[step + 1])
