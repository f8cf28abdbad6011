"""The port's streaming Mimi and full-duplex ``RealtimeSession`` against the
JAX package's, on the CPU, in fp32 at ``config_tiny()``.

Both packages take the same numpy weights (drawn by the port's
initialisers):

- streaming Mimi, frame by frame: codes identical to the reference's
  streaming encode and to both packages' batch encode, waveforms within
  1e-5 of max |ref| of the reference's streaming and batch decode, with a
  window of 6 positions so the stream runs well past its KV ring (the
  published 250 is the same code at a longer ring);
- a greedy session (``audio_temperature = text_temperature = 0``): every
  frame's agent codes and text token identical to the reference's
  ``RealtimeSession`` and the agent audio within 1e-5; the codes equal to
  the port's own offline ``_converse`` over the same audio, the audio
  within 1e-5 of its offline ``respond``;
- ``batch=2`` with a voice prompt on one row only: each row identical to
  the reference's batched session and to a single session;
- ``kv_dtype=torch.int8``: codes and text identical to the reference's int8
  session;
- ``push_frames_async`` equal to ``push_frames``; wrong frame sizes raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_asr_swift_tpu.models.personaplex import PersonaPlex as JaxPlex
from qwen3_asr_swift_tpu.models.personaplex import PersonaSampling as JaxSampling
from qwen3_asr_swift_tpu.models.personaplex import mimi as jmimi
from qwen3_asr_swift_tpu.models.personaplex import model as jmodel
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.personaplex import PersonaPlex, PersonaSampling
from qwen3_asr_swift_tpu_torch.models.personaplex import mimi as pmimi
from qwen3_asr_swift_tpu_torch.models.personaplex import model as pmodel

TOL = 1e-5
CFG, JCFG = pmodel.config_tiny(), jmodel.config_tiny()
SPF = CFG.mimi.samples_per_frame
FRAMES = 5
GREEDY = dict(audio_temperature=0.0, text_temperature=0.0, max_steps=FRAMES,
              silence_stop_frames=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    params = pmodel.init_personaplex_params(rng, CFG)
    mimi = pmimi.init_mimi_params(rng, CFG.mimi)
    port = PersonaPlex(CFG, params, mimi, device="cpu", dtype=torch.float32)
    return port, JaxPlex(JCFG, params, mimi, dtype=jnp.float32)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    return (0.1 * rng.standard_normal((FRAMES, 2, SPF))).astype(np.float32)


def jax_session(model, frames, **kw):
    """The reference's session over ``frames`` [F, B, spf]: per frame (codes
    [B, 16], text tokens [B], audio [B, spf])."""
    s = model.realtime_session(JaxSampling(**GREEDY), **kw)
    out = []
    for f in frames:
        wav = s.push_frames(f)
        out.append((np.asarray(s.last_codes), np.asarray(s._state[4]), wav))
    return out


def port_session(model, frames, **kw):
    s = model.realtime_session(PersonaSampling(**GREEDY), **kw)
    out = []
    for f in frames:
        wav = s.push_frames(f)
        out.append((s.last_codes.numpy(), s._text.numpy(), wav))
    assert s.frames_done == len(frames)
    return out


def assert_sessions_equal(got, want):
    for i, ((gc, gt, gw), (wc, wt, ww)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gc, wc, err_msg=f"codes of frame {i}")
        np.testing.assert_array_equal(gt, wt, err_msg=f"text token of frame {i}")
        assert gw.shape == ww.shape and rel(gw, ww) < TOL, (i, rel(gw, ww))


# ---------------------------------------------------------------------------
# streaming Mimi
# ---------------------------------------------------------------------------

def test_streaming_mimi_matches_reference_past_the_ring():
    cfg = dataclasses.replace(CFG.mimi, sliding_window=6)
    jcfg = dataclasses.replace(jmimi.config_tiny(), sliding_window=6)
    m = pmimi.init_mimi_params(np.random.default_rng(9), cfg)
    pp, jp = params_from_jax(m, "cpu", torch.float32), jax.tree_util.tree_map(jnp.asarray, m)
    n = 14  # 2 transformer positions a frame: well past the 6-position window
    audio = (0.3 * np.random.default_rng(8).standard_normal((2, SPF * n))).astype(np.float32)
    p_st, j_st = pmimi.init_mimi_encoder_stream(pp, cfg, 2), jmimi.init_mimi_encoder_stream(
        jp, jcfg, 2)
    got, want = [], []
    for i in range(n):
        piece = audio[:, i * SPF:(i + 1) * SPF]
        c, p_st = pmimi.mimi_encode_frame(pp, cfg, p_st, torch.from_numpy(piece))
        jc, j_st = jmimi.mimi_encode_frame(jp, jcfg, j_st, jnp.asarray(piece))
        got.append(c.numpy())
        want.append(np.asarray(jc))
    got, want = np.concatenate(got, 2), np.concatenate(want, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pmimi.mimi_encode(pp, cfg, torch.from_numpy(audio)).numpy())

    codes = got
    p_st, j_st = pmimi.init_mimi_decoder_stream(pp, cfg, 2), jmimi.init_mimi_decoder_stream(
        jp, jcfg, 2)
    wav_p, wav_j = [], []
    for i in range(n):
        w, p_st = pmimi.mimi_decode_frame(pp, cfg, p_st, torch.from_numpy(codes[:, :, i:i + 1]))
        jw, j_st = jmimi.mimi_decode_frame(jp, jcfg, j_st, jnp.asarray(codes[:, :, i:i + 1]))
        wav_p.append(w.numpy())
        wav_j.append(np.asarray(jw))
    wav_p, wav_j = np.concatenate(wav_p, 1), np.concatenate(wav_j, 1)
    assert wav_p.shape == (2, n * SPF)
    assert rel(wav_p, wav_j) < TOL, rel(wav_p, wav_j)
    batch = np.asarray(jmimi.mimi_decode(jp, jcfg, jnp.asarray(codes)))
    assert rel(wav_p, batch) < TOL, rel(wav_p, batch)
    assert rel(pmimi.mimi_decode(pp, cfg, torch.from_numpy(codes)).numpy(), wav_p) < TOL


def test_streaming_mimi_published_window_first_chunk_edge_pad():
    """At the published 250-position window, several frames a call: the
    first chunk's replicate pad and the carries give the batch codes."""
    m = pmimi.init_mimi_params(np.random.default_rng(4), CFG.mimi)
    pp = params_from_jax(m, "cpu", torch.float32)
    audio = torch.from_numpy((0.3 * np.random.default_rng(5).standard_normal(
        (1, SPF * 6))).astype(np.float32))
    st = pmimi.init_mimi_encoder_stream(pp, CFG.mimi)
    got = []
    for lo, hi in ((0, 3), (3, 4), (4, 6)):
        c, st = pmimi.mimi_encode_frame(pp, CFG.mimi, st, audio[:, lo * SPF:hi * SPF])
        got.append(c)
    np.testing.assert_array_equal(torch.cat(got, 2).numpy(),
                                  pmimi.mimi_encode(pp, CFG.mimi, audio).numpy())


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

def test_greedy_session_matches_reference_and_offline(models, frames):
    port, ref = models
    one = frames[:, :1]
    got = port_session(port, one)
    assert_sessions_equal(got, jax_session(ref, one))
    assert all(np.isfinite(w).all() and w.shape == (1, SPF) for _, _, w in got)
    # the offline loop over the same audio, without the text penalty (respond
    # starts its text history after the user's turn, the session at once)
    clip = one[:, 0].reshape(-1)
    samp = PersonaSampling(**dict(GREEDY, text_repetition_penalty=1.0))
    agent, n_frames, n_done, _ = port._run_converse(clip, CFG.mimi.sample_rate, samp, 0.0, None)
    assert n_frames == n_done == FRAMES
    s = port.realtime_session(samp)
    codes, wavs = [], []
    for f in one:
        wavs.append(s.push_frames(f)[0])
        codes.append(torch.clamp(s.last_codes, 0, CFG.mimi.codebook_size - 1))
    np.testing.assert_array_equal(torch.stack(codes, 2).numpy(), agent.numpy())
    # and its audio is the offline respond's: the same codes, streamed
    offline = port.respond(clip, CFG.mimi.sample_rate, sampling=samp, max_extra_s=0.0)
    assert rel(np.concatenate(wavs), offline.samples) < TOL


def test_batched_sessions_match_reference_and_singles(models, frames):
    port, ref = models
    vp = port.make_voice_prompt(np.full(SPF * 3, 0.2, np.float32), CFG.mimi.sample_rate)
    got = port_session(port, frames, batch=2, voice_prompt=[None, vp])
    assert_sessions_equal(got, jax_session(ref, frames, batch=2, voice_prompt=[None, vp]))
    for row, row_vp in ((0, None), (1, vp)):
        single = port_session(port, frames[:, row:row + 1], voice_prompt=row_vp)
        rows = [(c[row:row + 1], t[row:row + 1], w[row:row + 1]) for c, t, w in got]
        assert_sessions_equal(single, rows)


def test_int8_kv_session_matches_reference(models, frames):
    port, ref = models
    one = frames[:, 1:2]
    got = port_session(port, one, kv_dtype=torch.int8)
    assert port.realtime_session(PersonaSampling(**GREEDY), kv_dtype=torch.int8) \
        ._cache.quantized
    assert_sessions_equal(got, jax_session(ref, one, kv_dtype=jnp.int8))


def test_push_frames_async_and_sizes(models, frames):
    port, _ = models
    samp = PersonaSampling(**GREEDY)
    sync = port.realtime_session(samp, batch=2)
    want = [sync.push_frames(f) for f in frames[:3]]
    async_ = port.realtime_session(samp, batch=2)
    outs = [async_.push_frames_async(f) for f in frames[:3]]
    assert all(isinstance(o, torch.Tensor) for o in outs)
    for w, o in zip(want, outs):
        np.testing.assert_array_equal(o.numpy(), w)
    single = port.realtime_session(samp)
    assert single.push_frame(frames[0, 0]).shape == (SPF,)
    with pytest.raises(ValueError):
        single.push_frame(np.zeros(7, np.float32))
    with pytest.raises(ValueError):
        sync.push_frame(frames[0, 0])
    with pytest.raises(ValueError):
        sync.push_frames(frames[0, :1])
