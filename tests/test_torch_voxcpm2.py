"""VoxCPM2 (``qwen3_asr_swift_tpu_torch/models/voxcpm2``) against its JAX
twin on the CPU.

One numpy-drawn tree at ``config_tiny()`` (every leaf jittered) goes to
both packages. The reference draws each step's CFM start with
``jax.random`` (one key split a step); these tests replay that key tree
and hand the port the draws. Modules within 1e-5 of max |reference| (fp32
both); the whole patch loop within 1e-4 with identical ``n_steps``, the
stop forced at chosen steps in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.voxcpm2 import convert as j_convert
from qwen3_asr_swift_tpu.models.voxcpm2 import model as j_model
from qwen3_asr_swift_tpu.models.voxcpm2 import vae as j_vae
from qwen3_asr_swift_tpu.ops import kv_cache as j_kv
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.voxcpm2 import convert as p_convert
from qwen3_asr_swift_tpu_torch.models.voxcpm2 import model as p_model
from qwen3_asr_swift_tpu_torch.models.voxcpm2 import vae as p_vae
from qwen3_asr_swift_tpu_torch.ops import kv_cache as p_kv
from test_voxcpm2_convert import _synthetic_checkpoint

TOL = 1e-5
# the loop feeds each patch back through LocEnc and both LMs into the next
# CFM solve, so fp32 rounding grows along it
LOOP_TOL = 1e-4
MAX_TOKENS = 20
CFG = dataclasses.replace(p_model.config_tiny(), max_tokens=MAX_TOKENS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The patch loop is a chain of small ops: with several test workers on
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


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err
    return err


def rnd(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def tree():
    return jitter(p_model.init_voxcpm2_params(np.random.default_rng(0), CFG),
                  np.random.default_rng(1))


@pytest.fixture(scope="module")
def models(tree):
    return jx(tree), params_from_jax(tree, "cpu", torch.float32)


def replay_starts(seed, max_tokens, cfg=CFG):
    """The start of each step's CFM solve that ``_generate`` draws from
    ``PRNGKey(seed)``: [max_tokens, 1, patch, latent]."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(max_tokens):
        key, kd = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(kd, (1, cfg.patch_size, cfg.latent_dim))))
    return torch.from_numpy(np.asarray(out, np.float32))


def test_configs_match_reference():
    assert dataclasses.asdict(p_model.config_tiny()) == dataclasses.asdict(j_model.config_tiny())
    assert dataclasses.asdict(p_model.CONFIG_2B) == dataclasses.asdict(j_model.CONFIG_2B)
    for which in ("base", "residual", "enc", "dit"):
        assert p_model.CONFIG_2B.dims(which) == j_model.CONFIG_2B.dims(which)
    for n in (2, 10):
        np.testing.assert_array_equal(p_model.cfm_time_span(n), j_model.cfm_time_span(n))


def test_initializer_tree_matches_reference():
    mine = p_model.init_voxcpm2_params(np.random.default_rng(0), CFG)
    ref = jax.eval_shape(lambda: j_model.init_voxcpm2_params(jax.random.PRNGKey(0), CFG))
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [(p, np.shape(a)) for p, a in flat_m] == [(p, a.shape) for p, a in flat_r]


def test_loc_enc_matches(models):
    jp, pp = models
    patches = rnd(2, 2, 5, CFG.patch_size, CFG.latent_dim)
    close(p_model.loc_enc(pp["feat_encoder"], CFG, torch.from_numpy(patches)),
          j_model.loc_enc(jp["feat_encoder"], CFG, jnp.asarray(patches)))


def test_fsq_matches(models):
    jp, pp = models
    x = rnd(3, 2, 7, CFG.hidden_size)
    close(p_model.fsq(pp["fsq_layer"], CFG, torch.from_numpy(x)),
          j_model.fsq(jp["fsq_layer"], CFG, jnp.asarray(x)))


def test_dit_velocity_matches(models):
    jp, pp = models
    b = 3
    x = rnd(4, b, CFG.patch_size, CFG.latent_dim)
    cond = rnd(5, b, CFG.patch_size, CFG.latent_dim)
    mu = rnd(6, b, 2 * CFG.dit_hidden)
    t, dt = np.float32([0.9, 0.5, 0.1]), np.float32([0.0, 0.2, 0.0])
    close(p_model.dit_velocity(pp["feat_decoder"], CFG, *map(torch.from_numpy, (x, mu, cond, t, dt))),
          j_model.dit_velocity(jp["feat_decoder"], CFG, *map(jnp.asarray, (x, mu, cond, t, dt))))


@pytest.mark.parametrize("steps", [2, 10])
def test_cfm_sample_matches_given_the_same_start(models, steps):
    jp, pp = models
    cfg = dataclasses.replace(CFG, cfm_steps=steps)
    mu = rnd(7, 1, 2 * CFG.dit_hidden)
    cond = rnd(8, 1, CFG.patch_size, CFG.latent_dim)
    key = jax.random.PRNGKey(9)
    want = j_model.cfm_sample(jp["feat_decoder"], cfg, jnp.asarray(mu), jnp.asarray(cond), key)
    x0 = np.asarray(jax.random.normal(key, (1, CFG.patch_size, CFG.latent_dim), jnp.float32))
    got = p_model.cfm_sample(pp["feat_decoder"], cfg, torch.from_numpy(mu),
                             torch.from_numpy(cond), torch.from_numpy(x0))
    close(got, want)


@pytest.mark.parametrize("which", ["base", "residual"])
def test_lm_forward_prefill_and_cached_step_match(models, which):
    """A prefill with holes in ``valid`` (compacted positions), then one
    decode step through the cache."""
    jp, pp = models
    name = "base_lm" if which == "base" else "residual_lm"
    dims = CFG.dims(which)
    total, extra = 12, 4
    valid = np.ones(total, bool)
    valid[2:5] = False
    valid[10:] = False
    x = rnd(10, 1, total, CFG.hidden_size)
    positions = ((np.cumsum(valid) - 1) * valid)[None].astype(np.int32)
    idx = np.arange(total)
    mask = np.where((idx[None] <= idx[:, None]) & valid[None], 0.0, -1e9).astype(np.float32)[None, None]
    jc = j_kv.init_cache(dims.layers, 1, dims.kv_heads, total + extra, dims.head_dim, jnp.float32)
    jh, nl = j_model._lm_forward(jp[name], jnp.asarray(x), jnp.asarray(positions), jnp.asarray(mask),
                                 jc, dims, CFG)
    jc = j_kv.after_prefill(jc, nl, jnp.asarray(valid)[None], total)
    pc = p_kv.init_cache(dims.layers, 1, dims.kv_heads, total + extra, dims.head_dim, torch.float32,
                         device="cpu")
    ph = p_model._lm_forward(pp[name], torch.from_numpy(x), torch.from_numpy(positions),
                             torch.from_numpy(mask), pc, dims, CFG)
    p_kv.after_prefill(pc, torch.from_numpy(valid)[None], total)
    close(ph, jh)
    step = rnd(11, 1, 1, CFG.hidden_size)
    jpos = jc.positions[:, None]
    written = jnp.arange(total + extra)[None, :] == jc.cursor
    jm = jnp.where(jc.valid | written, 0.0, -1e9).astype(jnp.float32)[:, None, None, :]
    jd, _ = j_model._lm_forward(jp[name], jnp.asarray(step), jpos, jm, jc, dims, CFG, True,
                                jc.cursor)
    cols = torch.arange(total + extra)
    pm = torch.where(pc.valid | (cols == pc.cursor)[None], 0.0, -1e9).float()[:, None, None, :]
    pd = p_model._lm_forward(pp[name], torch.from_numpy(step), pc.positions[:, None].clone(), pm,
                             pc, dims, CFG, cursor=pc.cursor)
    close(pd, jd)


def test_vae_encode_decode_and_transposed_conv_match(models):
    jp, pp = models
    v = CFG.vae
    wave = rnd(12, 2, v.hop_length * 6, scale=0.3)
    close(p_vae.vae_encode(pp["audio_vae"], v, torch.from_numpy(wave)),
          j_vae.vae_encode(jp["audio_vae"], v, jnp.asarray(wave)))
    lat = rnd(13, 1, 5, CFG.latent_dim)
    close(p_vae.vae_decode(pp["audio_vae"], v, torch.from_numpy(lat)),
          j_vae.vae_decode(jp["audio_vae"], v, jnp.asarray(lat)))
    blk = 1
    x = rnd(14, 1, 7, v.decoder_dim // 2)
    stride = v.decoder_rates[blk]
    kw = dict(stride=stride, padding=int(np.ceil(stride / 2)), output_padding=stride % 2)
    close(p_vae.causal_transpose_conv(torch.from_numpy(x), pp["audio_vae"]["decoder"]["blocks"][blk]
                                      ["conv_t"], **kw),
          j_vae.causal_transpose_conv(jnp.asarray(x), jp["audio_vae"]["decoder"]["blocks"][blk]
                                      ["conv_t"], **kw))


class ForcedStop:
    """Both packages' stop head replaced by one that fires exactly at step
    ``at``: a step is recognized by its CFM start (the reference's key of
    that step, the port's start tensor of that step), which each package's
    loop hands to ``cfm_sample`` just before it reads the stop head. Every
    other computation is the packages' own. ``at=None`` never fires."""

    def __init__(self, at, seed):
        self.key = None
        if at is not None:
            key = jax.random.PRNGKey(seed)
            for _ in range(at + 1):
                key, kd = jax.random.split(key)
            self.key = kd
            self.start = replay_starts(seed, at + 1)[at]
        self.current = None

    def patch(self, mp):
        j_cfm, p_cfm, j_lin = j_model.cfm_sample, p_model.cfm_sample, j_model.linear

        def j_cfm_sample(p, cfg, mu, cond, key):
            self.current = key
            return j_cfm(p, cfg, mu, cond, key)

        def j_linear(x, p):
            y = j_lin(x, p)
            if p["kernel"].shape[-1] != 2:              # only the stop head has 2 outputs
                return y
            hit = (jnp.all(self.current == self.key) if self.key is not None
                   else jnp.asarray(False))
            return jnp.where(hit, jnp.asarray([[-10.0, 10.0]]), jnp.asarray([[10.0, -10.0]]))

        def p_cfm_sample(p, cfg, mu, cond, x0):
            self.current = x0
            return p_cfm(p, cfg, mu, cond, x0)

        def p_stop(p, lm_hidden):
            hit = self.key is not None and torch.equal(self.current, self.start)
            return torch.tensor([[-10.0, 10.0]] if hit else [[10.0, -10.0]])

        mp.setattr(j_model, "cfm_sample", j_cfm_sample)
        mp.setattr(j_model, "linear", j_linear)
        mp.setattr(p_model, "cfm_sample", p_cfm_sample)
        mp.setattr(p_model, "_stop_logits", p_stop)


def _run_both(tree, text="hello there", voice=None, instruct=None, seed=3):
    ref = j_model.VoxCPM2TTS(CFG, jx(tree))
    port = p_model.VoxCPM2TTS(CFG, tree, device="cpu")
    arr, n, ref_pad, n_ref = port.prepare(text, voice, instruct)
    want, want_n = ref._generate(ref.params, jnp.asarray(arr), jnp.asarray(n, jnp.int32),
                                 jnp.asarray(ref_pad), jnp.asarray(n_ref, jnp.int32),
                                 jax.random.PRNGKey(seed), t_bucket=len(arr),
                                 max_tokens=MAX_TOKENS)
    got, got_n, loop = p_model.generate_patches(port.params, CFG, arr, n, ref_pad, n_ref,
                                                replay_starts(seed, MAX_TOKENS), MAX_TOKENS,
                                                torch.float32)
    return (np.asarray(want), int(want_n)), (got.numpy(), int(got_n)), loop


# stops: before min_tokens (ignored), at min_tokens (ignored: the test is
# step > min_tokens), the first step allowed, each position of the second
# 8-patch read window (steps 8-15), the last step, and never
@pytest.mark.parametrize("at", [1, 2, 3, 8, 9, 10, 11, 12, 13, 14, 15, 19, None])
def test_generate_matches_with_the_stop_forced(tree, at):
    forced = ForcedStop(at, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        forced.patch(mp)
        (want, want_n), (got, got_n), loop = _run_both(tree)
    expect = MAX_TOKENS if at is None or at <= CFG.min_tokens else at + 1
    assert want_n == got_n == expect
    close(got[:got_n], want[:want_n], LOOP_TOL)
    assert not got[got_n:].any()
    # the flag is read every 8 patches: at most 7 steps run past the stop
    assert got_n <= loop["steps_run"] <= min(MAX_TOKENS, got_n + p_model.STOP_CHECK_PATCHES - 1)


def test_generate_matches_with_the_stop_head_live(tree):
    (want, want_n), (got, got_n), _ = _run_both(tree, text="a longer line of text to say")
    assert want_n == got_n
    close(got[:got_n], want[:want_n], LOOP_TOL)


@pytest.fixture(scope="module")
def pair(tree):
    ref = j_model.VoxCPM2TTS(CFG, jx(tree))
    port = p_model.VoxCPM2TTS(CFG, tree, device="cpu")
    port._starts = lambda seed, max_tokens: replay_starts(seed, max_tokens)
    return ref, port


@pytest.mark.parametrize("case", ["plain", "voice", "instruct"])
def test_synthesize_matches_reference(pair, case):
    ref, port = pair
    kw = {}
    if case == "voice":
        kw["voice"] = rnd(15, 3 * 48000, scale=0.1)          # 3 s at 48 kHz
    if case == "instruct":
        kw["instruct"] = "a calm low voice"
    want = ref.synthesize("hi there", seed=5, max_tokens=8, **kw)
    got = port.synthesize("hi there", seed=5, max_tokens=8, **kw)
    assert got.sample_rate == want.sample_rate == 48000
    assert len(got.samples) == len(want.samples) > 0
    close(got.samples, want.samples, LOOP_TOL)
    if case == "voice":
        close(port.encode_reference(kw["voice"]), ref.encode_reference(kw["voice"]))


def test_convert_checkpoint_and_from_pretrained(tmp_path):
    from safetensors.numpy import save_file

    sd = _synthetic_checkpoint(np.random.default_rng(3))
    save_file(sd, str(tmp_path / "model.safetensors"))
    want_cfg, want = j_convert.convert_checkpoint(tmp_path)
    got_cfg, got = p_convert.convert_checkpoint(tmp_path)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(path))
    model = p_model.VoxCPM2TTS.from_pretrained(str(tmp_path), device="cpu", dtype=torch.float32)
    assert model.cfg == got_cfg and model.tokenizer is None
    assert model.params["audio_vae"]["encoder"]["conv_in"]["w"].dtype == torch.float32
    out = model.synthesize("hello world", max_tokens=3)
    assert out.sample_rate == got_cfg.sample_rate and np.isfinite(out.samples).all()
    bf16 = p_model.VoxCPM2TTS.from_pretrained(str(tmp_path), device="cpu")
    assert bf16.params["base_lm"]["embed_tokens"].dtype == torch.bfloat16
    assert bf16.params["audio_vae"]["decoder"]["conv_out"]["w"].dtype == torch.float32


def test_reference_first_patch_ignores_the_text(tree):
    """A fault of the reference the port keeps (ROADMAP §3): the prefix's
    hidden state is read at slot n_valid + n_ref + 1 of the padded layout.
    With no reference clip and a short text that is a padded reference slot
    that attends to [103] alone, so two texts of one length give one first
    patch, in both packages."""
    firsts = {}
    for text in ("hello there", "other words", "a text of forty-one characters, at least"):
        (want, _), (got, _), _ = _run_both(tree, text=text)
        close(got[0], want[0], LOOP_TOL)
        firsts[text] = want[0], got[0]
    (w1, g1), (w2, g2), (_, g3) = firsts.values()
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(g1, g2)
    assert not np.array_equal(g1, g3)     # past 31 tokens the slot is a text slot
