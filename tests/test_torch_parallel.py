"""The multi-device path of Qwen3-ASR: the port's ``parallel/`` and
``Qwen3ASR.shard`` over four gloo ranks on the CPU, against the JAX
package's sharded path on its eight virtual CPU devices.

One spawn of four ranks (one intra-op thread each, a join timeout) runs
every rank-side check; the JAX side runs in this process meanwhile. The
weights are drawn with numpy and cross over with ``params_from_jax``:

- dp2×tp2 on a batch of 5 (padded to 6) with chunked decode: transcripts
  equal to JAX's dp4×tp2 model, and each rank's ``per_device_shape``
  its 3 rows; one long clip on the same model takes the sequence-parallel
  encode, and its transcript equals one device's;
- dp4 sequence-parallel encode over 5 windows (zero-padded to 8): tokens
  within 1e-5 of JAX's ``encode(..., sp_mesh=...)``;
- the int4-packed decoder at tp 2: the transcript equals JAX's sharded
  packed model's; with K1 and K3 taking their plain versions on CPU
  tensors, the launch counters stay 0; a teacher-forced decode step
  within 1e-4 relative L2 of one device's with the table dequantized to
  fp32 and a float32 cache, and within the packed paths' 5e-2 with the
  packed table, whose bf16 rows put every activation in bf16 (ROADMAP §3
  entry 27);
- tp 4 over a decoder of 2 kv heads: its attention stays whole (the heads
  check) while its MLP shards, and the transcripts are unchanged;
- a sampled decode on dp2×tp2 equals one device's (the noise is drawn
  for the whole batch);
- the refusals: beam under dp, group-dot under any mesh, the slot pool on
  a sharded model and a bad ``dp*tp``, with the reference's messages.
"""

import concurrent.futures
import dataclasses
import re

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu_torch.core.params import init_random_params
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.parallel import spawn

WORLD = 4
MAX_TOKENS = 6


def shrink(cfg):
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))


def dense_weights():
    return init_random_params(config_tiny(), 0)


def packed_weights():
    return init_random_params(shrink(config_tiny()), 0, quant_bits=4)


def packed_cfg(cfg):
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, bits=4,
                                                                group_size=64))


def batch_clips():
    rng = np.random.default_rng(17)
    return [(0.1 * rng.standard_normal(16000)).astype(np.float32) for _ in range(5)]


def long_clip():
    return (0.1 * np.random.default_rng(3).standard_normal(10 * 16000)).astype(np.float32)


def sine_clip():
    return (0.1 * np.sin(np.linspace(0, 500, 16000))).astype(np.float32)


def sp_inputs(cfg):
    n_win = 5
    t_frames = cfg.n_window_infer * n_win
    mel = np.random.default_rng(n_win).standard_normal((cfg.n_mels, t_frames)).astype(np.float32)
    return mel, t_frames - 53


SAMPLED = dict(max_tokens=MAX_TOKENS, temperature=0.7, top_k=40)


def port_dense(**kw):
    enc, dec = dense_weights()
    return Qwen3ASR(config_tiny(), enc, dec, device="cpu", dtype=torch.float32,
                    audio_buckets_s=(8, 16), **kw)


def port_packed(**kw):
    enc, dec = packed_weights()
    return Qwen3ASR(packed_cfg(shrink(config_tiny())), enc, dec, device="cpu",
                    dtype=torch.float32, audio_buckets_s=(8,), **kw)


def step_logits(model):
    """A teacher-forced decode step after the sine clip's prefill, fed a
    fixed token: with the packed table (bf16 activations) and with the
    table dequantized to fp32 and a float32 cache."""
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr.decoder import decode_step
    from qwen3_asr_swift_tpu_torch.ops.quant import dequantize
    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    params, kv = model.decoder_params, model.kv_dtype
    dense = dict(params, embed_tokens=dequantize(params["embed_tokens"],
                                                 model.cfg.decoder.hidden_size))
    out = {}
    with torch.inference_mode():
        st = model.prestage([sine_clip()])       # one row a rank, a copy of the clip on dp 1
        audio = model._encode(st)
        for key, tree, kv_dtype in (("bf16", params, kv), ("fp32", dense, torch.float32)):
            model.decoder_params, model.kv_dtype = tree, kv_dtype
            state = model._gen_start(*audio, model._prompt(st.b, None, None), 4,
                                     SamplingOptions(max_tokens=4))
            logits, _ = decode_step(tree, model.cfg.decoder, torch.tensor([5]), state.cache,
                                    model._mesh)
            out[key] = logits.numpy()
    model.decoder_params, model.kv_dtype = params, kv
    return out


def texts(results):
    return [r.text for r in results]


def raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def rank_checks(rank):
    """Every rank-side check, run on each of the four ranks."""
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr.encoder import encode
    from qwen3_asr_swift_tpu_torch.ops.attention_int8 import K3_LAUNCHES
    from qwen3_asr_swift_tpu_torch.ops.quant import K1_LAUNCHES
    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions
    from qwen3_asr_swift_tpu_torch.parallel import make_mesh
    from qwen3_asr_swift_tpu_torch.serving.slotpool import SlotPoolASR

    out = {}
    mesh = make_mesh(dp=2, tp=2)
    out["coords"] = (mesh.dp_rank, mesh.tp_rank)

    # dp2 x tp2, a batch of 5, monolithic then chunked; one long clip (sp)
    model = port_dense().shard(mesh=mesh)
    out["dp_tp"] = texts(model.transcribe_batch(batch_clips(), max_tokens=MAX_TOKENS))
    out["per_device_shape"] = model.last_staging["per_device_shape"]
    model.decode_chunk_tokens = 2
    out["dp_tp_chunked"] = texts(model.transcribe_batch(batch_clips(), max_tokens=MAX_TOKENS))
    out["sp_text"] = model.transcribe(long_clip(), max_tokens=4).text
    out["sp_staging"] = model.last_staging["sharding"]
    out["sampled"] = texts(model.transcribe_batch(
        batch_clips(), options=SamplingOptions(**SAMPLED), seed=5))
    out["beam_refused"] = raises(lambda: model.transcribe_batch(
        batch_clips(), options=SamplingOptions(max_tokens=3, beam=2)))
    out["pool_refused"] = raises(lambda: SlotPoolASR(model))
    out["bad_mesh"] = raises(lambda: make_mesh(dp=3, tp=1))
    out["groupdot_refused"] = raises(lambda: port_packed(quant_compute="groupdot").shard(dp=4))

    # dp4 sequence-parallel encode over 5 windows
    sp_mesh = make_mesh(dp=4, tp=1)
    cfg = config_tiny().encoder
    mel, n_valid = sp_inputs(cfg)
    whole = port_dense()
    tok, n_tok = encode(whole.encoder_params, torch.from_numpy(mel)[None],
                        torch.tensor([n_valid]), cfg, sp_mesh=sp_mesh)
    out["sp_tokens"], out["sp_n"] = tok[0].numpy(), int(n_tok[0])

    # the int4-packed decoder at tp 2 (dp 2): K1/K3 take their plain versions
    k1, k3 = K1_LAUNCHES.value, K3_LAUNCHES.value
    packed = port_packed(kv_dtype=torch.int8).shard(mesh=mesh)
    gate = packed.decoder_params["layers"][0]["mlp"]["gate_proj"]["codes"]
    out["packed_gate_rows"] = gate.shape[0]
    out["packed_text"] = packed.transcribe(sine_clip(), max_tokens=4).text
    out["packed_step"] = step_logits(packed)
    out["launches"] = (K1_LAUNCHES.value - k1, K3_LAUNCHES.value - k3)

    # tp 4 over 2 kv heads: the decoder's attention stays whole
    tp4 = make_mesh(dp=1, tp=4)
    whole.shard(mesh=tp4)
    out["tp4"] = texts(whole.transcribe_batch(batch_clips(), max_tokens=MAX_TOKENS))
    layer = whole.decoder_params["layers"][0]
    out["tp4_widths"] = {name: layer[name]["kernel"].shape for name in
                         ("q_proj", "k_proj", "v_proj", "o_proj")}
    out["tp4_widths"].update({name: layer["mlp"][name]["kernel"].shape for name in
                              ("gate_proj", "up_proj", "down_proj")})
    return out


def jax_side():
    """The reference's sharded runs on its eight virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from qwen3_asr_swift_tpu.models.qwen3_asr import Qwen3ASR as JaxQwen3ASR
    from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jax_tiny
    from qwen3_asr_swift_tpu.models.qwen3_asr.encoder import encode as jax_encode
    from qwen3_asr_swift_tpu.ops.sampling import SamplingOptions as JaxOptions
    from qwen3_asr_swift_tpu.parallel import make_mesh
    from qwen3_asr_swift_tpu.serving.slotpool import SlotPoolASR as JaxPool

    ref = {}
    enc, dec = dense_weights()
    jm = JaxQwen3ASR(jax_tiny(), enc, dec, dtype=jnp.float32, audio_buckets_s=(8, 16))
    jm.shard(mesh=make_mesh(8, dp=4, tp=2))
    ref["dp_tp"] = texts(jm.transcribe_batch(batch_clips(), max_tokens=MAX_TOKENS))
    ref["beam_refused"] = raises(lambda: jm.transcribe_batch(
        batch_clips(), options=JaxOptions(max_tokens=3, beam=2)))
    ref["pool_refused"] = raises(lambda: JaxPool(jm))
    ref["bad_mesh"] = raises(lambda: make_mesh(8, dp=3, tp=2))

    cfg = jax_tiny().encoder
    mel, n_valid = sp_inputs(cfg)
    tok, n_tok = jax.jit(lambda p, m, n: jax_encode(p, m, n, cfg, sp_mesh=make_mesh(8, dp=4, tp=2)))(
        jm.encoder_params, jnp.asarray(mel), jnp.asarray(n_valid, jnp.int32))
    ref["sp_tokens"], ref["sp_n"] = np.asarray(tok), int(n_tok)

    enc, dec = packed_weights()
    jp = JaxQwen3ASR(packed_cfg(shrink(jax_tiny())), enc, dec, dtype=jnp.float32,
                     audio_buckets_s=(8,))
    jp.shard(mesh=make_mesh(8, dp=4, tp=2))
    ref["packed_text"] = jp.transcribe(sine_clip(), max_tokens=4).text
    ref["groupdot_refused"] = raises(lambda: JaxQwen3ASR(
        packed_cfg(shrink(jax_tiny())), enc, dec, dtype=jnp.float32, audio_buckets_s=(8,),
        quant_compute="groupdot").shard(dp=1, tp=1))
    return ref


@pytest.fixture(scope="module")
def runs():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, rank_checks, WORLD, device="cpu", timeout=300)
        ref = jax_side()
        return ranks.result(), ref


def test_mesh_is_dp_major(runs):
    ranks, _ = runs
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_dp2_tp2_batch_of_five_chunked_equals_reference(runs):
    ranks, ref = runs
    for r in ranks:
        assert r["dp_tp"] == ref["dp_tp"]
        assert r["dp_tp_chunked"] == ref["dp_tp"]
        assert r["per_device_shape"][0] == 3      # 5 clips padded to 6, over dp 2


def test_long_clip_takes_sp_encode_and_equals_one_device(runs):
    ranks, _ = runs
    want = port_dense().transcribe(long_clip(), max_tokens=4).text
    for r in ranks:
        assert r["sp_staging"] == "sequence-parallel"
        assert r["sp_text"] == want


def test_dp4_sp_encode_nondivisible_windows_within_1e5(runs):
    ranks, ref = runs
    for r in ranks:
        assert r["sp_n"] == ref["sp_n"]
        assert r["sp_tokens"].shape == ref["sp_tokens"].shape
        np.testing.assert_allclose(r["sp_tokens"], ref["sp_tokens"], atol=1e-5, rtol=0)


def test_int4_packed_tp2_equals_reference(runs):
    ranks, ref = runs
    for r in ranks:
        assert r["packed_gate_rows"] == 256 // 2          # the gate's codes cut over tp 2
        assert r["packed_text"] == ref["packed_text"]
        assert r["launches"] == (0, 0)                    # CPU tensors: plain versions


def test_teacher_forced_step_on_tp_shards(runs):
    ranks, _ = runs
    want = step_logits(port_packed(kv_dtype=torch.int8))
    for r in ranks:
        got = r["packed_step"]
        rel = {k: np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k]) for k in want}
        assert rel["fp32"] <= 1e-4, rel
        assert rel["bf16"] <= 5e-2, rel


def test_heads_check_keeps_attention_whole_results_unchanged(runs):
    ranks, _ = runs
    single = port_dense()
    want = texts(single.transcribe_batch(batch_clips(), max_tokens=MAX_TOKENS))
    d = config_tiny().decoder
    hq, hkv, inter = d.num_heads * d.head_dim, d.num_kv_heads * d.head_dim, d.intermediate_size
    for r in ranks:
        assert r["tp4_widths"] == {           # [in, out]: attention whole, the MLP cut over tp 4
            "q_proj": (d.hidden_size, hq), "k_proj": (d.hidden_size, hkv),
            "v_proj": (d.hidden_size, hkv), "o_proj": (hq, d.hidden_size),
            "gate_proj": (d.hidden_size, inter // 4), "up_proj": (d.hidden_size, inter // 4),
            "down_proj": (inter // 4, d.hidden_size)}
        assert r["tp4"] == want


def test_sampled_dp_decode_equals_one_device(runs):
    from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions

    ranks, _ = runs
    want = texts(port_dense().transcribe_batch(batch_clips(),
                                               options=SamplingOptions(**SAMPLED), seed=5))
    for r in ranks:
        assert r["sampled"] == want


@pytest.mark.parametrize("what", ["beam_refused", "pool_refused", "groupdot_refused",
                                  "bad_mesh"])
def test_refusals_match_reference(runs, what):
    ranks, ref = runs
    for r in ranks:
        assert r[what] is not None and ref[what] is not None
        if what == "bad_mesh":
            pattern = r"dp\(\d+\) \* tp\(\d+\) != devices\(\d+\)"
            assert re.fullmatch(pattern, r[what]) and re.fullmatch(pattern, ref[what])
        else:
            assert r[what] == ref[what]
