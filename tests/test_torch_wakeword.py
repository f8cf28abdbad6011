"""The Zipformer wake word (``qwen3_asr_swift_tpu_torch/models/wakeword``)
against its JAX twin on the CPU.

One numpy-drawn tree at the published ``ZipformerConfig()`` (3.19M
parameters with the transducer head; every leaf jittered, so the bypass
scales, BiasNorm's log-scales and the downsample biases are not trivial)
goes to both packages. ``embed_chunk`` with a carried ConvNeXt pad,
``encode_chunk`` over three chunks and every cache it carries within 1e-5
of max |reference| (fp32 both); the batch path's frames within 1e-5 and
its detections identical, with the joiner sharpened and its blank biased
so that random weights fire keywords; the batch frames equal a session's
whatever the push sizes (the reference's property, held at its own
tolerance, 2e-5); ``finalize``'s silence-padded tail and ``reset``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.wakeword import model as j_model
from qwen3_asr_swift_tpu.models.wakeword import zipformer as j_zip
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.wakeword import model as p_model
from qwen3_asr_swift_tpu_torch.models.wakeword import zipformer as p_zip
from qwen3_asr_swift_tpu_torch.models.wakeword.context_graph import Keyword

TOL = 1e-5
CFG = p_zip.ZipformerConfig()
J_CFG = j_zip.ZipformerConfig()
# the joiner sharpened x20 and its blank biased so that random weights emit
# blanks between tokens, and keywords of the tokens this tree emits
SHARPEN, BLANK_BIAS = 20.0, 2.29
KEYWORDS = [("one", [156]), ("two", [103, 156]), ("three", [103])]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The window loop is a chain of small ops: with several test workers
    on the host, torch's intra-op threads only contend."""
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


@pytest.fixture(scope="module")
def tree():
    t = jitter(p_zip.init_zipformer_params(np.random.default_rng(0), CFG), np.random.default_rng(1))
    t["joiner"]["output_linear"]["kernel"] *= SHARPEN
    t["joiner"]["output_linear"]["bias"][0] += BLANK_BIAS * SHARPEN
    return t


def keywords(mod):
    return [mod.Keyword(name, ids, threshold=0.2) for name, ids in KEYWORDS]


@pytest.fixture(scope="module")
def pair(tree):
    return (j_model.WakeWordDetector(jax.tree_util.tree_map(jnp.asarray, tree),
                                     keywords(j_model), config=J_CFG),
            p_model.WakeWordDetector(tree, keywords(p_model), config=CFG, device="cpu"))


def noise(n, seed=7):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def leaves(states):
    """A state dict's leaves in the reference's pytree order."""
    if isinstance(states, dict):
        return [x for k in sorted(states) for x in leaves(states[k])]
    if isinstance(states, list):
        return [x for v in states for x in leaves(v)]
    return [np.asarray(states)]


def same_hits(got, want):
    """Detections equal: phrase, tokens, timestamps and frame; the score (a
    mean token probability) within 1e-4, the joiner's x20 amplifying the
    frames' 1e-6 of rounding."""
    key = lambda h: (h.phrase, list(h.token_ids), list(h.timestamps), h.frame_index)
    assert [key(h) for h in got] == [key(h) for h in want]
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=1e-4)


def test_config_and_param_count_match(tree):
    assert dataclasses.asdict(CFG) == dataclasses.asdict(J_CFG)
    assert p_zip.param_count(tree) == j_zip.param_count(jax.tree_util.tree_map(jnp.asarray, tree))
    assert p_zip.param_count(tree) == 3_190_609
    assert p_model._PAD_MEL == j_model._PAD_MEL


def test_embed_chunk_matches(pair):
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, CFG.mel_window, CFG.num_mel_bins)).astype(np.float32)
    pad = rng.standard_normal((2, 6, CFG.embed_freq_out, CFG.embed_channels[2])).astype(np.float32)
    want = j_zip.embed_chunk(pair[0].params["embed"], jnp.asarray(mel), jnp.asarray(pad))
    with torch.inference_mode():
        got = p_zip.embed_chunk(pair[1].params["embed"], torch.from_numpy(mel),
                                torch.from_numpy(pad))
    close(got[0], want[0])
    close(got[1], want[1])


def test_encode_chunk_and_its_states_match(pair):
    """Three chunks in a row: each chunk's frames and every carried cache
    (attention keys, both value caches, the nonlin cache, both conv caches,
    the ConvNeXt pad, the processed count) within 1e-5 of the reference's."""
    rng = np.random.default_rng(3)
    js, ps = j_zip.init_states(J_CFG), p_zip.init_states(CFG, device="cpu")
    assert [x.shape for x in leaves(ps)] == [x.shape for x in jax.tree_util.tree_leaves(js)]
    for _ in range(3):
        mel = rng.standard_normal((1, CFG.mel_window, CFG.num_mel_bins)).astype(np.float32)
        jo, js = pair[0]._encode_chunk(pair[0].params, mel_window=jnp.asarray(mel), states=js)
        with torch.inference_mode():
            po, ps = p_zip.encode_chunk(pair[1].params, CFG, torch.from_numpy(mel), ps)
        close(po, jo)
        for got, want in zip(leaves(ps), jax.tree_util.tree_leaves(js)):
            close(got, want)


def test_batch_frames_and_detections_match(pair):
    """The batch path (fbank of the clip, windows by index, the loop over
    windows): frames within 1e-5 of the reference's and detections
    identical, several of them."""
    audio = noise(16000 * 4)
    want = pair[0]._batch_encoder_frames(audio)
    got = pair[1]._batch_encoder_frames(audio)
    close(got, want)
    hits = pair[0].detect_keywords(audio)
    assert len(hits) >= 2, hits
    same_hits(pair[1].detect_keywords(audio), hits)
    assert pair[1].detect_keywords(audio[:300]) == pair[0].detect_keywords(audio[:300]) == []


@pytest.mark.parametrize("pushes", [[16000 * 3 + 555], [7440, 1, 5119, 10000, 33], [3000] * 17])
def test_batch_frames_equal_session_frames(pair, pushes):
    """The reference's property in the port: a session fed the clip in any
    pushes, then finalized (its silence-padded tail), gives the batch's
    frames and the batch's detections."""
    audio = noise(sum(pushes), 11)
    session = p_model.WakeWordSession(pair[1], collect_encoder=True)
    hits, at = [], 0
    for n in pushes:
        hits += session.push(audio[at: at + n])
        at += n
    hits += session.finalize()
    frames = np.concatenate(session.encoder_frames)
    np.testing.assert_allclose(frames, pair[1]._batch_encoder_frames(audio), atol=2e-5)
    same_hits(hits, pair[1].detect_keywords(audio))
    session.reset()
    assert len(session._buf) == 0
    np.testing.assert_array_equal(session._states["processed"].numpy(), [0])


def test_session_matches_the_reference_session(pair):
    audio = noise(16000 * 2 + 999, 13)
    got, want = (p_model.WakeWordSession(pair[1], collect_encoder=True),
                 j_model.WakeWordSession(pair[0], collect_encoder=True))
    for s in (got, want):
        s.push(audio[:9000])
        s.push(audio[9000:])
        s.finalize()
    assert len(got.encoder_frames) == len(want.encoder_frames) == 6
    close(np.concatenate(got.encoder_frames), np.concatenate(want.encoder_frames))


def test_transducer_head_is_the_reference_head(pair):
    dec_p, dec_j = pair[1].make_kws_decoder(), pair[0].make_kws_decoder()
    for ctx in ([], [5], [7, 9], [-1, 0]):
        d = dec_p.decoder_fn(ctx)
        np.testing.assert_array_equal(d, dec_j.decoder_fn(ctx))
        enc = np.random.default_rng(len(ctx)).standard_normal(CFG.joiner_dim).astype(np.float32)
        np.testing.assert_array_equal(dec_p.joiner_fn(enc, d), dec_j.joiner_fn(enc, d))


def test_init_random_draws_on_the_device_from_a_seed():
    kw = [Keyword("hey", [5, 6])]
    a = p_model.WakeWordDetector.init_random(kw, seed=3, device="cpu")
    b = p_model.WakeWordDetector.init_random(kw, seed=3, device="cpu")
    assert torch.equal(a.params["encoder_proj"]["kernel"], b.params["encoder_proj"]["kernel"])
    assert a.num_params() == 3_190_609
    assert params_from_jax(a.params, "cpu", torch.float32)["embed"]["conv0"]["w"].shape == \
        (3, 3, 1, 8)
