"""The port's Qwen3-ASR encoder and decoder against the JAX package, module
by module, at the group-64-compatible tiny config of tests/test_quant.py.

Tolerances (relative to max |reference|, or relative L2 where stated):
- encoder 1e-4: fp32 throughout; convs and attention sum in another order;
- prefill hidden states 1e-4: fp32 embeds in, fp32 group decomposition;
- decode-step logits 1e-4 with a dense fp32 decoder. With a packed decoder
  the activations are bf16 in both packages (the packed embedding lookup
  returns bf16 rows), so a single bf16 rounding that lands the other way
  moves logits by ~1e-3; 2e-2 relative L2 bounds that.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_asr_swift_tpu.models.qwen3_asr.decoder as jdec
import qwen3_asr_swift_tpu.ops.attention_pallas as jap
from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jax_tiny
from qwen3_asr_swift_tpu.models.qwen3_asr import encoder as jenc
from qwen3_asr_swift_tpu.ops.quant import cast_tree, dequantize_tree
from qwen3_asr_swift_tpu_torch.core.params import init_random_params, params_from_jax
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import config_tiny
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import decoder as pdec
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import encoder as penc
from qwen3_asr_swift_tpu_torch.ops import quant as pq


def shrink(cfg):
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))


CFG, JCFG = shrink(config_tiny()), shrink(jax_tiny())


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def weights():
    return init_random_params(CFG, seed=0, quant_bits=4)


def test_encoder_matches_reference(weights):
    enc, _ = weights
    rng = np.random.default_rng(1)
    t_frames = 1600
    mel = rng.standard_normal((2, CFG.encoder.n_mels, t_frames)).astype(np.float32)
    n_valid = np.array([1600, 733])
    got, n_tok = penc.encode(params_from_jax(enc, "cpu", torch.float32), torch.from_numpy(mel),
                             torch.from_numpy(n_valid), CFG.encoder)
    jparams = cast_tree(enc, jnp.float32)
    for i in range(2):
        ref, ref_n = jenc.encode(jparams, jnp.asarray(mel[i]), jnp.int32(n_valid[i]), JCFG.encoder)
        assert int(n_tok[i]) == int(ref_n)
        assert rel(got[i].numpy(), np.asarray(ref)) <= 1e-4


def test_valid_tokens_and_positions():
    frames = torch.tensor([0, 1, 99, 100, 101, 733, 1600])
    got = penc._valid_tokens(frames, CFG.encoder).tolist()
    ref = [int(jenc._valid_tokens(jnp.int32(f), JCFG.encoder)) for f in frames.tolist()]
    assert got == ref
    np.testing.assert_array_equal(penc.sinusoidal_positions(13, 64), jenc.sinusoidal_positions(13, 64))


def _decoder_pair(dec, dense: bool):
    """(JAX fused fp32 params, port fused fp32 params)."""
    if dense:
        dec = dequantize_tree(dec, 4, 64, jnp.float32)
    jparams = jdec.fuse_for_inference(cast_tree(dec, jnp.float32), JCFG.decoder)
    pparams = pdec.fuse_for_inference(params_from_jax(dec, "cpu", torch.float32), CFG.decoder)
    return jparams, pparams


def _prompt(seed, t=40):
    rng = np.random.default_rng(seed)
    embeds = (0.5 * rng.standard_normal((2, t, CFG.decoder.hidden_size))).astype(np.float32)
    valid = np.ones((2, t), bool)
    valid[1, 10:18] = False   # padded audio rows
    valid[0, t - 3:] = False
    return embeds, valid


@pytest.mark.parametrize("dense", [False, True])
def test_prefill_hidden_states(weights, dense):
    _, dec = weights
    jparams, pparams = _decoder_pair(dec, dense)
    embeds, valid = _prompt(2)
    jcache = jdec.make_cache(JCFG.decoder, 2, 48, jnp.float32)
    ref, jcache = jdec.prefill(jparams, JCFG.decoder, jnp.asarray(embeds), jnp.asarray(valid), jcache)
    pcache = pdec.make_cache(CFG.decoder, 2, 48, torch.float32)
    got, pcache = pdec.prefill(pparams, CFG.decoder, torch.from_numpy(embeds), torch.from_numpy(valid), pcache)
    mask = valid[..., None]
    assert rel(got.numpy() * mask, np.asarray(ref) * mask) <= 1e-4
    np.testing.assert_array_equal(pcache.positions.numpy(), np.asarray(jcache.positions))
    assert rel(pcache.layers[1].k.numpy(), np.asarray(jcache.layers[1].k)) <= 1e-4


@pytest.mark.parametrize("dense,kv", [(True, "float32"), (True, "int8"), (False, "float32"),
                                      (False, "int8")])
def test_decode_step_logits(weights, dense, kv, monkeypatch):
    _, dec = weights
    if kv == "int8":
        # hold the reference to its own kernel's semantics (the Pallas
        # kernel in interpret mode), which the port's K3 implements
        monkeypatch.setattr(jdec, "_pallas_attn_ok", lambda: True)
        monkeypatch.setattr(jap, "decode_attention_int8",
                            functools.partial(jap.decode_attention_int8, interpret=True))
    jparams, pparams = _decoder_pair(dec, dense)
    embeds, valid = _prompt(3)
    jdt, pdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.float32, torch.float32)
    jcache = jdec.make_cache(JCFG.decoder, 2, 48, jdt)
    _, jcache = jdec.prefill(jparams, JCFG.decoder, jnp.asarray(embeds), jnp.asarray(valid), jcache)
    pcache = pdec.make_cache(CFG.decoder, 2, 48, pdt)
    _, pcache = pdec.prefill(pparams, CFG.decoder, torch.from_numpy(embeds), torch.from_numpy(valid), pcache)
    ids = np.array([5, 300], np.int32)
    for step in range(2):
        ref, jcache = jdec.decode_step(jparams, JCFG.decoder, jnp.asarray(ids), jcache)
        got, pcache = pdec.decode_step(pparams, CFG.decoder, torch.from_numpy(ids).long(), pcache)
        assert got.dtype == torch.float32
        if dense:
            assert rel(got.numpy(), np.asarray(ref)) <= 1e-4
        else:
            assert rel_l2(got.numpy(), np.asarray(ref)) <= 2e-2
        ids = np.asarray(ref).argmax(-1).astype(np.int32)
    assert pcache.cursor == int(jcache.cursor)
    np.testing.assert_array_equal(pcache.valid.numpy(), np.asarray(jcache.valid))


def test_packed_decoder_uses_k1_wrapper_for_decode_rows(weights, monkeypatch):
    """Decode-shaped products (≤256 rows) go through the K1 wrapper, the
    prefill-shaped ones through the plain decomposition."""
    _, dec = weights
    _, pparams = _decoder_pair(dec, dense=False)
    calls = []
    real = pq.quant_matmul_cuda
    monkeypatch.setattr(pq, "quant_matmul_cuda", lambda x, p: calls.append(x.shape) or real(x, p))
    embeds, valid = _prompt(4, t=140)  # 280 rows: prefill-shaped
    cache = pdec.make_cache(CFG.decoder, 2, 150, torch.int8)
    pdec.prefill(pparams, CFG.decoder, torch.from_numpy(embeds), torch.from_numpy(valid), cache)
    assert calls == []
    pdec.decode_step(pparams, CFG.decoder, torch.tensor([1, 2]), cache)
    # 2 layers × (qkv, o, gate_up, down) + the LM head
    assert len(calls) == 2 * 4 + 1
