"""VibeVoice (``qwen3_asr_swift_tpu_torch/models/vibevoice``) against its JAX
twin on the CPU.

One numpy-drawn tree at ``config_tiny()`` (every leaf jittered, so the
biases, norms, layer scales and the latent scaling are not the
initializer's zeros and ones) goes to both packages. The reference draws
each frame's DPM start with ``jax.random`` (one key split a frame); these
tests replay that key tree in jax and hand the port the draws. Tolerance
1e-5 of max |reference| (fp32 both); frame counts and EOS decisions
identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.vibevoice import convert as j_convert
from qwen3_asr_swift_tpu.models.vibevoice import diffusion as j_diff
from qwen3_asr_swift_tpu.models.vibevoice import model as j_model
from qwen3_asr_swift_tpu.models.vibevoice import tokenizer as j_tok
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.vibevoice import convert as p_convert
from qwen3_asr_swift_tpu_torch.models.vibevoice import diffusion as p_diff
from qwen3_asr_swift_tpu_torch.models.vibevoice import model as p_model
from qwen3_asr_swift_tpu_torch.models.vibevoice import tokenizer as p_tok
from test_cosyvoice_vibevoice import _export_upstream_vibevoice

TOL = 1e-5
# The frame loop chains the prefill, a CFG solve (whose guidance scales the
# gap between two head outputs) and the LM step that feeds each latent back,
# so fp32 rounding grows along it: over 8 frames the reference drifts up to
# 4.8e-6 and the port up to 1.1e-5 of max |ref| from a float64 run of the
# port (test_frame_loop_as_accurate_as_reference), and the two part by up to
# 1.5e-5 already at a first frame. Every stage
# alone holds 1e-5; the loop's latents and the audio decoded from them are
# held to 1e-4, with identical frame counts.
LOOP_TOL = 1e-4
CFG = p_model.config_tiny()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The frame and solver loops are chains of small ops: with several
    test workers on the host, torch's intra-op threads only contend."""
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


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def pt(tree):
    return params_from_jax(tree, "cpu", torch.float32)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


@pytest.fixture(scope="module")
def tree():
    t = jitter(p_model.init_vibevoice_params(np.random.default_rng(0), CFG),
               np.random.default_rng(1))
    # the EOS head fires late enough for several frames (measured below)
    t["eos_classifier"]["fc2"]["bias"] = np.asarray([-1.0], np.float32)
    return t


def replay_starts(seed, max_frames, latent):
    """The DPM start of each frame that ``generate_frames`` draws from
    ``PRNGKey(seed)``: [max_frames, latent]."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(max_frames):
        key, kd = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(kd, (1, latent), jnp.float32))[0])
    return torch.from_numpy(np.asarray(out, np.float32))


def replay(model):
    model._starts = lambda seed, max_frames: replay_starts(seed, max_frames, model.cfg.latent_dim)
    return model


def test_configs_match_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(j_model.config_tiny())
    assert dataclasses.asdict(p_model.CONFIG_05B) == dataclasses.asdict(j_model.CONFIG_05B)
    assert CFG.tokenizer.decoder_latent_receptive == j_model.config_tiny().tokenizer.decoder_latent_receptive
    for name in ("NEGATIVE_TEXT_ID", "SPEECH_START_ID", "SPEECH_END_ID", "SPEECH_DIFFUSION_ID",
                 "SYSTEM_PROMPT"):
        assert getattr(p_model, name) == getattr(j_model, name), name


def test_initializer_tree_matches_reference():
    mine = p_model.init_vibevoice_params(np.random.default_rng(0), CFG)
    ref = jax.eval_shape(lambda: j_model.init_vibevoice_params(jax.random.PRNGKey(0), CFG))
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [(p, np.shape(a)) for p, a in flat_m] == [(p, a.shape) for p, a in flat_r]


# -- the σ-VAE -------------------------------------------------------------------

def test_encode_and_decode_match(tree):
    cfg = CFG.tokenizer
    tok = tree["acoustic_tokenizer"]
    audio = np.random.default_rng(2).standard_normal((1, 5 * cfg.total_ratio)).astype(np.float32)
    mean = p_tok.encode(pt(tok), cfg, torch.from_numpy(audio))
    close(mean, jax.jit(j_tok.encode, static_argnums=1)(jx(tok), cfg, jnp.asarray(audio)))
    lat = np.random.default_rng(3).standard_normal((1, 6, cfg.vae_dim)).astype(np.float32)
    close(p_tok.decode(pt(tok), cfg, torch.from_numpy(lat)),
          jax.jit(j_tok.decode, static_argnums=1)(jx(tok), cfg, jnp.asarray(lat)))
    noise = np.random.default_rng(4).standard_normal(lat.shape).astype(np.float32)
    close(p_tok.sample_latents(torch.from_numpy(lat), torch.from_numpy(noise), cfg.fix_std),
          lat + cfg.fix_std * noise)


def test_decode_chunked_equals_full_decode(tree):
    cfg = CFG.tokenizer
    tok = pt(tree["acoustic_tokenizer"])
    lat = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 13, cfg.vae_dim))
                           .astype(np.float32))
    full = p_tok.decode(tok, cfg, lat)
    chunked = p_tok.decode_chunked(tok, cfg, lat, chunk=4)
    close(chunked, full)
    want = jax.jit(j_tok.decode_chunked, static_argnums=(1, 3))(
        jx(tree["acoustic_tokenizer"]), cfg, jnp.asarray(lat.numpy()), 4)
    close(chunked, want)


@pytest.mark.parametrize("k,s", [(4, 2), (16, 8), (9, 3)])
def test_transpose_conv_matches_scatter_and_reference(k, s):
    """y[s·t + j] += x[t]·W[:, :, j], trimmed by k - s on the right, with the
    kernel as both packages' converters leave it."""
    rng = np.random.default_rng(k + s)
    cin, cout, t = 3, 5, 6
    w = rng.standard_normal((cin, cout, k)).astype(np.float32)   # torch layout
    b = rng.standard_normal(cout).astype(np.float32)
    x = rng.standard_normal((1, t, cin)).astype(np.float32)
    full = np.zeros((s * (t - 1) + k, cout), np.float32)
    for ti in range(t):
        for ji in range(k):
            full[s * ti + ji] += x[0, ti] @ w[:, :, ji]
    want = (full + b)[: s * t]
    flat = {"up.convtr.convtr.weight": w, "up.convtr.convtr.bias": b}
    p = p_convert._Keys(flat).convtr("up")
    got = p_tok._sconv_transpose(torch.from_numpy(x), pt(p), s)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-5)
    ref = j_tok._sconv_transpose(jnp.asarray(x), jx(j_convert._Keys(flat).convtr("up")), s)
    close(got, ref)


# -- diffusion ----------------------------------------------------------------------

def test_solver_coefficients_equal():
    for steps in (4, 20):
        for got, want in zip(p_diff.solver_coefficients(p_diff.DiffusionConfig(), steps),
                             j_diff.solver_coefficients(j_diff.DiffusionConfig(), steps)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg_scale", [1.5, None])
def test_dpm_solve_matches(tree, cfg_scale):
    cfg = CFG.diffusion
    p = tree["prediction_head"]
    rng = np.random.default_rng(6)
    cond = rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
    neg = rng.standard_normal((2, cfg.hidden_size)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw_j = {} if cfg_scale is None else dict(neg_condition=jnp.asarray(neg), cfg_scale=cfg_scale)
    kw_p = {} if cfg_scale is None else dict(neg_condition=torch.from_numpy(neg),
                                             cfg_scale=cfg_scale)
    want = j_diff.dpm_solve(jx(p), cfg, jnp.asarray(cond), key, **kw_j)
    start = torch.from_numpy(np.array(jax.random.normal(key, (2, cfg.latent_size))))
    got = p_diff.dpm_solve(pt(p), cfg, torch.from_numpy(cond), start, **kw_p)
    close(got, want)


# -- the model end to end --------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tree):
    return j_model.VibeVoiceTTS(CFG, jx(tree)), replay(p_model.VibeVoiceTTS(CFG, tree,
                                                                          device="cpu"))


NO_VOICE = np.zeros((0, CFG.latent_dim), np.float32)
CASES = [("hello there", 0), ("a much longer line of text", 3), ("hello", 5), ("x y z", 7)]


@pytest.mark.parametrize("text,seed", CASES)
def test_generate_frames_latents_and_count_match(models, text, seed):
    ref, port = models
    want, n_want = ref._run(text, NO_VOICE, 8, seed)
    got, n_got = port._run(text, NO_VOICE, 8, seed)
    assert n_got == n_want
    close(got[:n_got], want[:n_want], LOOP_TOL)
    assert port.last_loop["frames_run"] >= n_got


def test_frame_loop_as_accurate_as_reference(models, tree):
    """Each package's latents against a float64 run of the port, and the EOS
    stop inside the cap for one case (so the stop itself is compared)."""
    ref, port = models
    exact = replay(p_model.VibeVoiceTTS(CFG, tree, device="cpu", dtype=torch.float64))
    counts = []
    for text, seed in CASES:
        (want, n), (got, _), (e, n_e) = (m._run(text, NO_VOICE, 8, seed)
                                         for m in (ref, port, exact))
        assert n_e == n
        counts.append(n)
        scale = np.abs(want[:n]).max()
        ref_err, port_err = np.abs(want[:n] - e[:n]).max(), np.abs(got[:n] - e[:n]).max()
        print(f"{text!r}: {n} frames; reference {ref_err / scale:.3g}, port "
              f"{port_err / scale:.3g} of max |ref| from float64")
        assert ref_err <= LOOP_TOL * scale and port_err <= LOOP_TOL * scale
    assert any(1 < n < 8 for n in counts), counts


def test_eos_cadence_does_not_change_frames(models, monkeypatch):
    _, port = models
    runs = []
    for every in (1, 8):
        monkeypatch.setattr(p_model, "EOS_CHECK_FRAMES", every)
        lat, n = port._run("a much longer line of text", NO_VOICE, 8, 3)
        runs.append((lat[:n].tolist(), n))
    assert runs[0] == runs[1]


def test_eos_stop_with_rigged_weights(tree):
    rigged = jitter(tree, np.random.default_rng(9), 0.0)
    rigged["eos_classifier"]["fc2"]["bias"] = np.asarray([100.0], np.float32)
    ref = j_model.VibeVoiceTTS(CFG, jx(rigged))
    port = replay(p_model.VibeVoiceTTS(CFG, rigged, device="cpu"))
    want = ref.synthesize("anything", max_frames=8, seed=0).samples
    got = port.synthesize("anything", max_frames=8, seed=0).samples
    assert len(got) == len(want) == CFG.vae_upsample      # exactly one frame
    close(got, want)


def test_synthesize_matches(models):
    ref, port = models
    want = ref.synthesize("hello there", seed=1).samples
    got = port.synthesize("hello there", seed=1).samples
    assert len(want) > CFG.vae_upsample
    close(got, want, LOOP_TOL)


def test_generate_long_matches(models):
    ref, port = models
    text = "First sentence here. Second sentence follows. Third one ends."
    want = ref.generate_long(text, max_chars_per_chunk=25, max_frames=3, seed=1).samples
    got = port.generate_long(text, max_chars_per_chunk=25, max_frames=3, seed=1).samples
    assert len(want) > 0
    close(got, want, LOOP_TOL)


def test_encode_voice_npz_equal_and_voiced_synthesis(models, tmp_path):
    ref, port = models
    audio = np.random.default_rng(10).standard_normal(CFG.vae_upsample * 6).astype(np.float32)
    pw = ref.encode_voice(audio, "reference words", str(tmp_path / "ref.npz"))
    pg = port.encode_voice(audio, "reference words", str(tmp_path / "port.npz"))
    want, got = np.load(pw), np.load(pg)
    assert str(got["transcript"]) == str(want["transcript"]) == "reference words"
    close(got["latents"], want["latents"])
    close(port.synthesize("with voice", voice=str(pg), seed=0).samples,
          ref.synthesize("with voice", voice=str(pw), seed=0).samples, LOOP_TOL)


# -- checkpoints --------------------------------------------------------------------

def test_converter_leaf_for_leaf_and_from_pretrained(tree, tmp_path, monkeypatch):
    from safetensors.numpy import save_file

    flat = _export_upstream_vibevoice(tree, CFG)
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in flat.items()},
              str(tmp_path / "model.safetensors"))
    got = p_convert.convert_checkpoint(tmp_path, CFG)
    want = j_convert.convert_checkpoint(tmp_path, CFG)
    leaves_g = jax.tree_util.tree_leaves_with_path(got)
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in leaves_g] == [p for p, _ in leaves_w]
    for (path, a), (_, b) in zip(leaves_g, leaves_w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    # and back to the tree the checkpoint was written from
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=0,
                                   err_msg=str(path))
    monkeypatch.setattr(p_model, "CONFIG_05B", CFG)
    loaded = replay(p_model.VibeVoiceTTS.from_pretrained(str(tmp_path), device="cpu"))
    mem = replay(p_model.VibeVoiceTTS(CFG, tree, device="cpu"))
    np.testing.assert_array_equal(loaded.synthesize("parity", max_frames=3, seed=2).samples,
                                  mem.synthesize("parity", max_frames=3, seed=2).samples)


def test_model_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        p_model.VibeVoiceTTS.init_random(CFG)
