"""Streaming Parakeet EOU and Nemotron
(``qwen3_asr_swift_tpu_torch/models/parakeet_streaming``) against their JAX
twins on the CPU.

One numpy-drawn tree at ``config_tiny()`` (every leaf jittered) goes to
both packages. ``streaming_log_mel`` and its carried tail, ``encode_chunk``
and its caches over three chunks within 1e-5 of max |reference| (fp32
both); ``rnnt_chunk_decode``'s tokens, count, EOU flag, carried LSTM state
and last token identical, free-running, with every frame hitting the
symbol cap, and with EOU firing; a session's ``StreamingResult`` list over
pushes that split chunks unevenly equal (confidences within 1e-5), with
EOU confirmations, ``force_end_of_utterance`` and ``finalize``'s flushed
tail.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.parakeet_streaming import encoder as j_enc
from qwen3_asr_swift_tpu.models.parakeet_streaming import model as j_model
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.parakeet_streaming import encoder as p_enc
from qwen3_asr_swift_tpu_torch.models.parakeet_streaming import model as p_model
from qwen3_asr_swift_tpu_torch.models.parakeet_streaming.config import (
    CONFIG_EOU_120M, CONFIG_NEMOTRON_06B, config_tiny)

TOL = 1e-5
CFG = config_tiny()
J_CFG = j_model.config_tiny()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The chunk loop is a chain of small ops: with several test workers on
    the host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jitter(tree, rng, scale=0.05):
    if isinstance(tree, dict):
        return {k: jitter(v, rng, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jitter(v, rng, scale) for v in tree]
    return (tree + scale * rng.standard_normal(np.shape(tree))).astype(np.float32)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err
    return err


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    enc = jitter(p_enc.init_encoder_params(np.random.default_rng(0), CFG), np.random.default_rng(1))
    dec = jitter(p_model.init_decoder_params(np.random.default_rng(2), CFG),
                 np.random.default_rng(3), 0.5)
    return enc, dec


def with_eou_bias(dec, bias):
    """The decoder tree with the joint's EOU logit raised by ``bias``."""
    out = {**dec, "joint_out": dict(dec["joint_out"])}
    out["joint_out"]["bias"] = dec["joint_out"]["bias"].copy()
    out["joint_out"]["bias"][CFG.eou_token_id] += bias
    return out


def noise(n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def test_configs_match():
    for got, want in ((CFG, J_CFG), (CONFIG_EOU_120M, j_model.CONFIG_EOU_120M),
                      (CONFIG_NEMOTRON_06B, j_model.CONFIG_NEMOTRON_06B)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert p_model.NemotronStreamingASR.DEFAULT_CONFIG == CONFIG_NEMOTRON_06B
    assert (p_model.ParakeetStreamingASR.DEFAULT_MODEL_ID
            == j_model.ParakeetStreamingASR.DEFAULT_MODEL_ID)


def test_streaming_mel_and_encoder_caches_match(trees):
    """Three chunks in a row: the mel and its sample tail, then the encoder's
    frames and every cache (pre-mel, attention channel, conv time, the
    channel length as it fills to ``att_context``)."""
    enc = trees[0]
    jc, pc = j_enc.init_caches(J_CFG), p_enc.init_caches(CFG)
    params = params_from_jax(enc, "cpu", torch.float32)
    for i in range(3):
        chunk = noise(CFG.samples_per_chunk, i)[None]
        jm, jtail = j_enc.streaming_log_mel(jnp.asarray(chunk), jc.sample_tail, J_CFG)
        with torch.inference_mode():
            pm, ptail = p_enc.streaming_log_mel(torch.from_numpy(chunk), pc.sample_tail, CFG)
        close(pm, jm)
        np.testing.assert_array_equal(ptail.numpy(), np.asarray(jtail))
        jo, jc = j_enc.encode_chunk(to_jax(enc), J_CFG, jm, jc)
        with torch.inference_mode():
            po, pc = p_enc.encode_chunk(params, CFG, torch.from_numpy(np.array(jm)), pc)
        jc = dataclasses.replace(jc, sample_tail=jtail)
        pc = dataclasses.replace(pc, sample_tail=ptail)
        close(po, jo)
        for name in ("pre_mel", "channel", "time"):
            close(getattr(pc, name), getattr(jc, name))
        np.testing.assert_array_equal(pc.channel_len.numpy(), np.asarray(jc.channel_len))
    assert int(pc.channel_len[0]) == CFG.att_context


@pytest.mark.parametrize("case", ["free", "capped", "eou"])
def test_rnnt_chunk_decode_matches(trees, case):
    """Free-running; with blank and EOU pushed off so that every frame hits
    the symbol cap (the cap emits its token, then advances: n =
    frames × max_symbols, every write past it masked); with EOU pushed on
    (no token, the flag set)."""
    dec = trees[1]
    if case != "free":
        out = {**dec, "joint_out": dict(dec["joint_out"])}
        bias = out["joint_out"]["bias"] = dec["joint_out"]["bias"].copy()
        if case == "capped":
            bias[[CFG.vocab_size, CFG.eou_token_id]] -= 100.0
        else:
            bias[CFG.eou_token_id] += 100.0
        dec = out
    rng = np.random.default_rng(6)
    encoded = rng.standard_normal((CFG.out_frames, CFG.encoder_hidden)).astype(np.float32)
    h = rng.standard_normal((CFG.decoder_layers, 1, CFG.decoder_hidden)).astype(np.float32)
    c = rng.standard_normal((CFG.decoder_layers, 1, CFG.decoder_hidden)).astype(np.float32)
    want = j_model.rnnt_chunk_decode(to_jax(dec), J_CFG, jnp.asarray(encoded), jnp.asarray(h),
                                     jnp.asarray(c), jnp.asarray(7, jnp.int32))
    with torch.inference_mode():
        got = p_model.rnnt_chunk_decode(params_from_jax(dec, "cpu", torch.float32), CFG,
                                        torch.from_numpy(encoded), torch.from_numpy(h),
                                        torch.from_numpy(c), torch.tensor(7, dtype=torch.int32))
    n = int(want[2])
    assert int(got[2]) == n and bool(got[3]) == bool(want[3]) and int(got[6]) == int(want[6])
    np.testing.assert_array_equal(got[0].numpy()[:n], np.asarray(want[0])[:n])
    if n:
        close(got[1].numpy()[:n], np.asarray(want[1])[:n])
    close(got[4], want[4])
    close(got[5], want[5])
    max_out = CFG.out_frames * CFG.max_symbols_per_frame
    assert {"free": n > 0, "capped": n == max_out, "eou": n == 0}[case], n
    assert bool(want[3]) == (case == "eou")


def results(session, pushes, audio):
    out, at = [], 0
    for n in pushes:
        out += session.push_audio(audio[at: at + n])
        at += n
    return out


def same_results(got, want):
    key = lambda r: (r.text, r.is_final, r.eou_detected, r.segment_index)
    assert [key(r) for r in got] == [key(r) for r in want]
    np.testing.assert_allclose([r.confidence for r in got], [r.confidence for r in want],
                               rtol=1e-5)


@pytest.mark.parametrize("eou_bias,debounce", [(0.0, 1280), (17.6, 0)])
def test_session_results_match(trees, eou_bias, debounce):
    """Pushes that split chunks unevenly (0.1 chunk, 1.6 chunks, a few
    samples, the rest): the results equal; with the EOU logit raised to
    fire on some frames (a debounce of 0 confirms at once) a final and the
    next segment come from EOU; then a forced end of utterance and
    ``finalize``'s flushed tail."""
    enc, dec = trees[0], with_eou_bias(trees[1], eou_bias)
    ref = j_model.ParakeetStreamingASR(J_CFG, enc, dec)
    port = p_model.ParakeetStreamingASR(CFG, enc, dec, device="cpu")
    spc = CFG.samples_per_chunk
    pushes = [spc // 10, spc * 16 // 10, 7, spc * 9 + 333, spc // 2]
    audio = noise(sum(pushes), 8)
    sj, sp = ref.new_session(eou_debounce_ms=debounce), port.new_session(eou_debounce_ms=debounce)
    want, got = results(sj, pushes, audio), results(sp, pushes, audio)
    same_results(got, want)
    assert len(want) >= 3 and sp._tokens == sj._tokens
    if eou_bias:
        assert any(r.eou_detected for r in want), want
    forced = sp.force_end_of_utterance(), sj.force_end_of_utterance()
    assert (forced[0] is None) == (forced[1] is None)
    if forced[0] is not None:
        same_results([forced[0]], [forced[1]])
    more = noise(spc * 2 + 100, 9)
    same_results(sp.push_audio(more) + sp.finalize(), sj.push_audio(more) + sj.finalize())


def test_transcribe_and_stream_match(trees):
    ref = j_model.ParakeetStreamingASR(J_CFG, *trees)
    port = p_model.ParakeetStreamingASR(CFG, *trees, device="cpu")
    audio = noise(CFG.samples_per_chunk * 5 + 50, 12)
    want, got = ref.transcribe(audio), port.transcribe(audio)
    assert got.text == want.text and got.text
    np.testing.assert_allclose(got.confidence, want.confidence, rtol=1e-5)
    chunks = [audio[:1000], audio[1000:4000], audio[4000:]]
    key = lambda e: (e.text, e.is_final, e.segment_start, e.segment_end)
    assert [key(e) for e in port.transcribe_stream(chunks)] == \
        [key(e) for e in ref.transcribe_stream(chunks)]
