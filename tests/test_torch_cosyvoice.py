"""CosyVoice3 (``qwen3_asr_swift_tpu_torch/models/cosyvoice``) and the shared
Qwen2 layer (``ops/qwen2.py``) against their JAX twins on the CPU.

One numpy-drawn tree at ``config_tiny()`` (every leaf jittered, so biases,
norms and Snake alphas are not the initializer's zeros and ones) goes to
both packages. The reference draws noise with ``jax.random``; these tests
replay its key tree in jax and hand the port the draws it produces (the
LLM's two Gumbel vectors a step, the flow's start, the source's phase and
noises). Tolerance 1e-5 of max |reference| (fp32 both); speech tokens
identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.cosyvoice import dit as j_dit
from qwen3_asr_swift_tpu.models.cosyvoice import hift as j_hift
from qwen3_asr_swift_tpu.models.cosyvoice import model as j_model
from qwen3_asr_swift_tpu.ops.attention import NEG_INF
from qwen3_asr_swift_tpu.ops.qwen2 import qwen2_decoder_layer as j_layer
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.cosyvoice import dit as p_dit
from qwen3_asr_swift_tpu_torch.models.cosyvoice import hift as p_hift
from qwen3_asr_swift_tpu_torch.models.cosyvoice import model as p_model
from qwen3_asr_swift_tpu_torch.ops.qwen2 import qwen2_decoder_layer as p_layer

TOL = 1e-5
# The random vocoder amplifies fp32 rounding: whole syntheses of both
# packages lie 1e-5..6e-5 of max |ref| from a float64 run of the port
# (measured on the cases below), so the two fp32 waveforms are held to
# each other at 2e-4 and the port to no more than twice the reference's
# distance from float64; every stage alone holds 1e-5.
WAV_TOL = 2e-4
CFG = p_model.config_tiny()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The token and ODE loops are chains of small ops: with several test
    workers on the host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jitter(tree, rng, scale=0.05):
    """Every float leaf plus a little noise (shapes kept)."""
    if isinstance(tree, dict):
        return {k: jitter(v, rng, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jitter(v, rng, scale) for v in tree]
    return (tree + scale * rng.standard_normal(tree.shape)).astype(np.float32)


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def pt(tree):
    return params_from_jax(tree, "cpu", torch.float32)


def wav_close(got, want, exact):
    """``got`` (port) against ``want`` (reference), with ``exact`` a float64
    run of the port: within WAV_TOL of each other, and the port no farther
    from float64 than twice the reference."""
    got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
    assert got.shape == want.shape == exact.shape and len(got) > 0
    scale = np.abs(want).max()
    diff, ref_err, port_err = (np.abs(a - b).max() for a, b in
                               ((got, want), (want, exact), (got, exact)))
    assert diff <= WAV_TOL * scale, (diff, scale)
    assert port_err <= 2 * ref_err + 1e-6 * scale, (port_err, ref_err)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


@pytest.fixture(scope="module")
def tree():
    return jitter(p_model.init_cosyvoice_params(np.random.default_rng(0), CFG),
                  np.random.default_rng(1))


# -- replays of the reference's key tree ---------------------------------------

def replay_gumbel(seed, max_tokens, vocab):
    """The two Gumbel vectors a step that ``llm_generate_tokens`` draws from
    ``PRNGKey(seed)``: [max_tokens, 2, vocab]."""
    key = jax.random.PRNGKey(seed)
    out = []
    for step in range(max_tokens):
        key, kk = jax.random.split(key)
        k1, k2 = jax.random.split(kk)
        out.append([np.asarray(jax.random.gumbel(k, (vocab,), jnp.float32)) for k in (k1, k2)])
    return np.asarray(out, np.float32)


def replay_source(seed, cfg, b, s):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    n_h = cfg.nb_harmonics + 1
    return (np.array(jax.random.uniform(k1, (b, 1, n_h), maxval=2.0 * np.pi)),
            np.array(jax.random.normal(k2, (b, s, n_h))),
            np.array(jax.random.normal(k3, (b, s, 1))))


def replay_flow(seed, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def as_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def test_configs_match_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(j_model.config_tiny())
    assert dataclasses.asdict(p_model.CONFIG_05B) == dataclasses.asdict(j_model.CONFIG_05B)


def test_initializer_tree_matches_reference():
    """The numpy initializer builds the reference's tree: the same names and
    shapes."""
    mine = p_model.init_cosyvoice_params(np.random.default_rng(0), CFG)
    ref = jax.eval_shape(lambda: j_model.init_cosyvoice_params(jax.random.PRNGKey(0), CFG))
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [(p, a.shape) for p, a in flat_m] == [(p, a.shape) for p, a in flat_r]


# -- the shared Qwen2 layer -----------------------------------------------------

@pytest.fixture(scope="module")
def qwen2_layers(tree):
    return tree["layers"]


LAYER_KW = dict(num_heads=2, num_kv_heads=1, head_dim=16, rope_theta=1e6, rms_norm_eps=1e-6)


def _j_stack(layers, x, positions, mask, caches=None, start=0):
    outs = []
    for i, lp in enumerate(layers):
        kc, vc = caches[i] if caches else (None, None)
        x, kc, vc = j_layer(jx(lp), x, positions, mask, kc=kc, vc=vc,
                            start=None if kc is None else jnp.asarray(start), **LAYER_KW)
        outs.append((kc, vc))
    return x, outs


def test_qwen2_layer_prefill_matches(qwen2_layers):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    positions = np.tile(np.arange(9), (2, 1))
    rows, cols = np.arange(9)[:, None], np.arange(9)[None, :]
    mask = np.where(cols <= rows, 0.0, NEG_INF).astype(np.float32)[None, None]
    want, _ = _j_stack(qwen2_layers, jnp.asarray(x), jnp.asarray(positions), jnp.asarray(mask))
    got = torch.from_numpy(x)
    for lp in qwen2_layers:
        got = p_layer(pt(lp), got, torch.from_numpy(positions), torch.from_numpy(mask),
                      **LAYER_KW)
    close(got, want)


def test_qwen2_layer_cached_decode_matches_its_prefill(qwen2_layers):
    """Cached decode (a 3-token prefill, then one token at a time into the
    float cache) equals the port's own prefill, and the reference's."""
    rng = np.random.default_rng(3)
    t_total, t0 = 7, 3
    x = torch.from_numpy(rng.standard_normal((1, t_total, 32)).astype(np.float32))
    layers = [pt(lp) for lp in qwen2_layers]
    rows, cols = np.arange(t_total)[:, None], np.arange(t_total)[None, :]
    full_mask = torch.from_numpy(np.where(cols <= rows, 0.0, NEG_INF).astype(np.float32))[None, None]
    full = x
    positions = torch.arange(t_total)[None]
    for lp in layers:
        full = p_layer(lp, full, positions, full_mask, **LAYER_KW)

    caches = [(torch.zeros(1, 1, t_total, 16), torch.zeros(1, 1, t_total, 16)) for _ in layers]

    def step(part, start):
        t = part.shape[1]
        pos = start + torch.arange(t)[None]
        mask = torch.where(torch.arange(t_total)[None, None, None, :] <= pos[:, None, :, None],
                           0.0, NEG_INF)
        for lp, (kc, vc) in zip(layers, caches):
            part = p_layer(lp, part, pos, mask, kc=kc, vc=vc, start=start, **LAYER_KW)
        return part

    outs = [step(x[:, :t0], 0)] + [step(x[:, t:t + 1], t) for t in range(t0, t_total)]
    close(torch.cat(outs, dim=1), full)
    want, _ = _j_stack(qwen2_layers, jnp.asarray(x.numpy()), jnp.asarray(positions.numpy()),
                       jnp.asarray(full_mask.numpy()))
    close(full, want)


# -- flow -------------------------------------------------------------------------

J_DIT = jax.jit(j_dit.dit_forward, static_argnums=1)
J_HIFT = jax.jit(j_hift.hift_generate, static_argnums=1)


def test_dit_forward_matches_with_padding_masked(tree):
    cfg = CFG.flow.dit
    rng = np.random.default_rng(4)
    b, t = 2, 12
    x, mu, cond = (rng.standard_normal((b, t, cfg.mel_dim)).astype(np.float32) for _ in range(3))
    ts = np.asarray([0.3, 0.8], np.float32)
    spks = rng.standard_normal((b, cfg.spk_dim)).astype(np.float32)
    seq_mask = np.ones((b, t), bool)
    seq_mask[1, 9:] = False
    p = tree["flow"]["dit"]
    want = J_DIT(jx(p), cfg, *map(jnp.asarray, (x, mu, ts, spks, cond, seq_mask)))
    got = p_dit.dit_forward(pt(p), cfg, *as_torch(x, mu, ts, spks, cond, seq_mask))
    close(got, want)
    # without the optional inputs
    want = J_DIT(jx(p), cfg, jnp.asarray(x), jnp.asarray(mu), jnp.asarray(ts))
    got = p_dit.dit_forward(pt(p), cfg, *as_torch(x, mu, ts))
    close(got, want)


def test_encode_mu_and_speaker_projection_match(tree):
    tokens = np.random.default_rng(5).integers(0, CFG.flow.vocab_size, (2, 7))
    p = tree["flow"]
    close(p_dit.encode_mu(pt(p), CFG.flow, torch.from_numpy(tokens)),
          j_dit.encode_mu(jx(p), CFG.flow, jnp.asarray(tokens)))
    spk = np.random.default_rng(6).standard_normal((2, CFG.flow.spk_embed_dim)).astype(np.float32)
    close(p_dit.project_speaker(pt(p), torch.from_numpy(spk)),
          j_dit.project_speaker(jx(p), jnp.asarray(spk)))


def test_solve_flow_matches(tree):
    rng = np.random.default_rng(7)
    mu = rng.standard_normal((1, 10, CFG.flow.output_size)).astype(np.float32)
    spks = rng.standard_normal((1, CFG.flow.dit.spk_dim)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = j_dit.solve_flow(jx(tree["flow"]), CFG.flow, jnp.asarray(mu), key,
                            spks=jnp.asarray(spks), temperature=0.9, n_timesteps=4)
    noise = replay_flow(3, mu.shape)
    got = p_dit.solve_flow(pt(tree["flow"]), CFG.flow, *as_torch(mu, noise),
                           spks=torch.from_numpy(spks), temperature=0.9, n_timesteps=4)
    close(got, want)


def test_flow_generate_with_prompt_matches(tree):
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, CFG.flow.vocab_size, (1, 6))
    prompt = rng.integers(0, CFG.flow.vocab_size, (1, 3))
    feat = rng.standard_normal((1, 6, CFG.flow.output_size)).astype(np.float32)
    spk = rng.standard_normal((1, CFG.flow.spk_embed_dim)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = j_dit.flow_generate(jx(tree["flow"]), CFG.flow, jnp.asarray(tokens), key,
                               spk_embedding=jnp.asarray(spk), prompt_tokens=jnp.asarray(prompt),
                               prompt_feat=jnp.asarray(feat))
    noise = replay_flow(9, (1, 18, CFG.flow.output_size))
    got = p_dit.flow_generate(pt(tree["flow"]), CFG.flow, torch.from_numpy(tokens),
                              torch.from_numpy(noise), spk_embedding=torch.from_numpy(spk),
                              prompt_tokens=torch.from_numpy(prompt),
                              prompt_feat=torch.from_numpy(feat))
    close(got, want)


# -- HiFT -------------------------------------------------------------------------

def test_f0_and_source_match(tree):
    cfg = CFG.hift
    mel = np.random.default_rng(10).standard_normal((1, 5, cfg.in_channels)).astype(np.float32)
    p = tree["hift"]
    f0 = p_hift.f0_predict(pt(p), cfg, torch.from_numpy(mel))
    close(f0, jax.jit(j_hift.f0_predict, static_argnums=1)(jx(p), cfg, jnp.asarray(mel)))
    # voiced and unvoiced samples both
    f0_up = np.concatenate([np.full((1, 40), 180.0), np.full((1, 40), 3.0)], axis=1)
    f0_up = f0_up.astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jax.jit(j_hift.source_signal, static_argnums=1)(jx(p), cfg, jnp.asarray(f0_up), key)
    got = p_hift.source_signal(pt(p), cfg, torch.from_numpy(f0_up),
                               *as_torch(*replay_source(11, cfg, 1, 80)))
    close(got, want)


def test_stft_istft_reconstruction_matches():
    cfg = CFG.hift
    sig = np.random.default_rng(12).standard_normal((2, 64)).astype(np.float32)
    spec_p = p_hift.stft_source(torch.from_numpy(sig), cfg)
    spec_j = j_hift.stft_source(jnp.asarray(sig), cfg)
    close(spec_p, spec_j)
    n_bins = cfg.istft_n_fft // 2 + 1
    re_, im = spec_p[..., :n_bins], spec_p[..., n_bins:]
    mag, phase = torch.sqrt(re_ ** 2 + im ** 2), torch.atan2(im, re_)
    wav = p_hift.istft(mag, phase, cfg)
    close(wav, j_hift.istft(jnp.asarray(mag.numpy()), jnp.asarray(phase.numpy()), cfg))
    c = cfg.istft_n_fft // 2
    close(wav[:, c:c + 64], sig, tol=1e-4)      # perfect reconstruction, inside the pad


def test_hift_generate_matches(tree):
    cfg = CFG.hift
    mel = np.random.default_rng(13).standard_normal((1, 6, cfg.in_channels)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    want = J_HIFT(jx(tree["hift"]), cfg, jnp.asarray(mel), key)
    got = p_hift.hift_generate(pt(tree["hift"]), cfg, torch.from_numpy(mel),
                               as_torch(*replay_source(14, cfg, 1, 6 * cfg.samples_per_frame)))
    close(got, want)


def test_hift_as_accurate_as_reference(tree):
    """On a mel of the end-to-end path's size, each package's fp32 HiFT
    against a float64 run of the port's (the reference's distance vouches
    for the float64 run)."""
    cfg = CFG.hift
    mel = np.random.default_rng(16).standard_normal((1, 32, cfg.in_channels)).astype(np.float32)
    noise = replay_source(17, cfg, 1, 32 * cfg.samples_per_frame)
    want = np.asarray(J_HIFT(jx(tree["hift"]), cfg, jnp.asarray(mel), jax.random.PRNGKey(17)))
    got = p_hift.hift_generate(pt(tree["hift"]), cfg, torch.from_numpy(mel),
                               as_torch(*noise)).numpy()
    exact = p_hift.hift_generate(params_from_jax(tree["hift"], "cpu", torch.float64), cfg,
                                 torch.from_numpy(mel).double(),
                                 tuple(t.double() for t in as_torch(*noise))).numpy()
    scale = np.abs(want).max()
    ref_err, port_err = np.abs(want - exact).max(), np.abs(got - exact).max()
    diff = np.abs(got - want).max()
    print(f"HiFT: reference {ref_err / scale:.3g}, port {port_err / scale:.3g} of max |ref| "
          f"from the float64 run; port vs reference {diff / scale:.3g}")
    assert ref_err <= 1e-3 * scale and diff <= WAV_TOL * scale, (ref_err, diff, scale)
    assert port_err <= 2 * ref_err + 1e-6, (port_err, ref_err)


# -- LLM ----------------------------------------------------------------------------

J_LLM = jax.jit(j_model.llm_generate_tokens, static_argnames=("cfg", "max_tokens"))
LLM_CFG = dataclasses.replace(CFG, max_tokens=40, min_token_text_ratio=0.5)


def _llm_both(tree, ids, n_valid, seed, prompt=None, n_prompt=0, cfg=LLM_CFG):
    kw_j, kw_p = {}, {}
    if prompt is not None:
        kw_j = dict(prompt_speech=jnp.asarray(prompt), n_prompt=jnp.asarray(n_prompt, jnp.int32))
        kw_p = dict(prompt_speech=prompt, n_prompt=n_prompt)
    want, n_want = J_LLM(jx(tree), cfg, jnp.asarray(ids), jnp.asarray(n_valid, jnp.int32),
                         jax.random.PRNGKey(seed), cfg.max_tokens, **kw_j)
    gumbel = torch.from_numpy(replay_gumbel(seed, cfg.max_tokens, cfg.speech_vocab))
    got, n_got, loop = p_model.llm_generate_tokens(pt(tree), cfg, ids, n_valid, gumbel,
                                                   cfg.max_tokens, **kw_p)
    return np.asarray(want), int(n_want), got.numpy(), int(n_got), loop


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_llm_tokens_identical(tree, seed):
    ids = np.zeros(16, np.int32)
    ids[:5] = [10, 20, 30, 40, 50]
    want, n_want, got, n_got, loop = _llm_both(tree, ids, 5, seed)
    np.testing.assert_array_equal(got, want)
    assert n_got == n_want
    assert loop["steps_run"] >= n_got and loop["done_reads"] >= 1


def test_llm_tokens_identical_with_prompt_speech(tree):
    ids = np.zeros(16, np.int32)
    ids[:3] = [7, 8, 9]
    prompt = np.zeros(16, np.int32)
    prompt[:4] = [1, 2, 3, 4]
    want, n_want, got, n_got, _ = _llm_both(tree, ids, 3, 5, prompt=prompt, n_prompt=4)
    np.testing.assert_array_equal(got, want)
    assert n_got == n_want


def test_llm_tokens_invariant_to_bucket_padding(tree):
    cfg = LLM_CFG
    gumbel = torch.from_numpy(replay_gumbel(4, cfg.max_tokens, cfg.speech_vocab))
    outs = []
    for bucket in (16, 32):
        ids = np.zeros(bucket, np.int32)
        ids[:4] = [11, 12, 13, 14]
        out, n, _ = p_model.llm_generate_tokens(pt(tree), cfg, ids, 4, gumbel, cfg.max_tokens)
        outs.append((out.numpy().tolist(), int(n)))
    assert outs[0] == outs[1]


def test_llm_done_cadence_does_not_change_tokens(tree, monkeypatch):
    cfg = LLM_CFG
    ids = np.zeros(16, np.int32)
    ids[:5] = [10, 20, 30, 40, 50]
    gumbel = torch.from_numpy(replay_gumbel(1, cfg.max_tokens, cfg.speech_vocab))
    runs = []
    for every in (1, 16):
        monkeypatch.setattr(p_model, "DONE_CHECK_TOKENS", every)
        out, n, loop = p_model.llm_generate_tokens(pt(tree), cfg, ids, 5, gumbel, cfg.max_tokens)
        runs.append((out.numpy().tolist(), int(n)))
    assert runs[0] == runs[1]


# -- the model end to end -----------------------------------------------------------

def replay_noise(model):
    """Point the port model's three draws at the reference's key tree."""
    cfg = model.cfg
    model._gumbel = lambda seed: torch.from_numpy(
        replay_gumbel(seed, cfg.max_tokens, cfg.speech_vocab))
    model._flow_noise = lambda seed, shape: as_torch(replay_flow(seed, shape))[0]
    model._source_noise = lambda seed, s: as_torch(*replay_source(seed, cfg.hift, 1, s))
    return model


@pytest.fixture(scope="module")
def models(tree):
    cfg = dataclasses.replace(CFG, max_tokens=16, min_token_text_ratio=0.5)
    ref = j_model.CosyVoiceTTS(cfg, jx(tree))
    port = replay_noise(p_model.CosyVoiceTTS(cfg, tree, device="cpu"))
    exact = replay_noise(p_model.CosyVoiceTTS(cfg, tree, device="cpu", dtype=torch.float64))
    return ref, port, exact


@pytest.mark.parametrize("text,seed", [("hello there", 0), ("a b", 3)])
def test_synthesize_matches(models, text, seed):
    ref, port, exact = models
    wav_close(port.synthesize(text, seed=seed).samples, ref.synthesize(text, seed=seed).samples,
              exact.synthesize(text, seed=seed).samples)


def test_synthesize_stream_chunks_match(models):
    chunks = [[c.samples for c in m.synthesize_stream("stream me", seed=1, chunk_tokens=4,
                                                     left_context=2)] for m in models]
    assert len(chunks[1]) == len(chunks[0]) == len(chunks[2]) > 1
    for want, got, exact in zip(*chunks):
        wav_close(got, want, exact)


def test_dialogue_and_icl_voice_match(models):
    rng = np.random.default_rng(15)
    emb = rng.standard_normal(192).astype(np.float32)
    ptoks = rng.integers(0, CFG.flow.vocab_size, 5).astype(np.int32)
    feat = rng.standard_normal((10, CFG.flow.output_size)).astype(np.float32)
    for m in models:
        m.register_voice("A", emb, prompt_tokens=ptoks, prompt_feat=feat)
        m.register_voice("B", emb[::-1].copy())
    script = "A: first line\nB: second line\ncontinued"
    want, got, exact = (m.synthesize_dialogue(script, seed=2).samples for m in models)
    wav_close(got, want, exact)


def test_clone_voice_needs_a_speaker_model(models, monkeypatch, tmp_path):
    """Without a speaker model, ``clone_voice`` loads CAM++ with
    ``CampPlusSpeaker.from_pretrained()`` on the model's device (the
    reference's default; here, offline on an empty cache, the missing
    snapshot raises); a given model's ``embed`` is used as it is."""
    from qwen3_asr_swift_tpu_torch.models.speaker import campplus

    port = models[1]
    seen = []

    def from_pretrained(*args, **kw):
        seen.append((args, kw))
        return campplus.CampPlusSpeaker.init_random(device="cpu")

    with monkeypatch.context() as m:
        m.setattr(campplus.CampPlusSpeaker, "from_pretrained", from_pretrained)
        port.clone_voice("x", np.full(16000, 0.1, np.float32))
    assert seen == [((), {"device": port.device})] and "x" in port.voices
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("QWEN3_CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises(FileNotFoundError, match="offline mode: no cached snapshot for "
                                                "aufklarer/CamPlusPlus"):
        port.clone_voice("x", np.zeros(16000, np.float32))

    class Embedder:
        def embed(self, audio, rate):
            return np.full(192, 0.5, np.float32)

    port.clone_voice("x", np.zeros(16000, np.float32), speaker_model=Embedder())
    np.testing.assert_array_equal(port.voices["x"].embedding, np.full(8, 0.5, np.float32))


def test_model_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        p_model.CosyVoiceTTS.init_random(CFG)


# -- checkpoints --------------------------------------------------------------------

def test_weight_norm_fusion_matches_torch():
    """The port's copy of ``fuse_weight_norm`` against torch's own
    materialized weight (dim 0), legacy and parametrize naming both."""
    import warnings

    from qwen3_asr_swift_tpu_torch.core.weights import fuse_weight_norm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        old = torch.nn.utils.weight_norm(torch.nn.Conv1d(3, 6, 5))
    new = torch.nn.utils.parametrizations.weight_norm(torch.nn.Conv1d(3, 6, 5))
    for mod in (old, new):
        flat = {f"x.{k}": v.detach().numpy() for k, v in mod.state_dict().items()}
        np.testing.assert_allclose(fuse_weight_norm(flat)["x.weight"],
                                   mod.weight.detach().numpy(), rtol=0, atol=1e-6)


def test_converter_leaf_for_leaf_and_from_pretrained(tree, tmp_path, monkeypatch):
    """An upstream llm/flow/hift checkpoint (HiFT convs as weight-norm
    pairs) that the test writes: both packages' converters give the same
    tree, and ``from_pretrained(dir)`` synthesizes as the in-memory model
    built from it."""
    from safetensors.numpy import save_file
    from test_cosyvoice_vibevoice import (_export_upstream_flow, _export_upstream_hift,
                                          _export_upstream_llm)

    from qwen3_asr_swift_tpu.models.cosyvoice import convert as j_convert
    from qwen3_asr_swift_tpu_torch.models.cosyvoice import convert as p_convert

    for stem, flat in (("llm", _export_upstream_llm(tree, CFG)),
                       ("flow", _export_upstream_flow(tree["flow"])),
                       ("hift", _export_upstream_hift(tree["hift"], CFG.hift))):
        save_file({k: np.ascontiguousarray(v, np.float32) for k, v in flat.items()},
                  str(tmp_path / f"{stem}.safetensors"))
    got = p_convert.convert_checkpoint(tmp_path, CFG)
    want = j_convert.convert_checkpoint(tmp_path, CFG)
    leaves_g = jax.tree_util.tree_leaves_with_path(got)
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in leaves_g] == [p for p, _ in leaves_w]
    for (path, a), (_, b) in zip(leaves_g, leaves_w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    assert [p for p, _ in leaves_g] == [p for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    # from_pretrained builds the published config; here the tiny one
    monkeypatch.setattr(p_model, "CONFIG_05B", CFG)
    monkeypatch.setattr(p_convert, "load_or_convert",
                        functools.partial(p_convert.load_or_convert, cfg=CFG))
    loaded = replay_noise(p_model.CosyVoiceTTS.from_pretrained(str(tmp_path), device="cpu"))
    mem = replay_noise(p_model.CosyVoiceTTS(CFG, got, device="cpu"))
    np.testing.assert_array_equal(loaded.synthesize("parity", seed=2).samples,
                                  mem.synthesize("parity", seed=2).samples)
