"""Kokoro-82M (``qwen3_asr_swift_tpu_torch/models/kokoro``) against its JAX
twin on the CPU.

One numpy-drawn tree at ``config_tiny()`` (every leaf jittered, so biases,
norms and Snake alphas are not the initializer's zeros and ones) goes to
both packages. The reference draws the harmonic source's noise with
``jax.random`` from ``PRNGKey(seed)``; these tests replay that draw and
hand the port the tensor. Stages within 1e-5 of max |reference| (fp32
both), durations and totals identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.kokoro import albert as j_albert
from qwen3_asr_swift_tpu.models.kokoro import convert as j_convert
from qwen3_asr_swift_tpu.models.kokoro import model as j_model
from qwen3_asr_swift_tpu.models.kokoro import phonemizer as j_ph
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.kokoro import albert as p_albert
from qwen3_asr_swift_tpu_torch.models.kokoro import convert as p_convert
from qwen3_asr_swift_tpu_torch.models.kokoro import model as p_model
from qwen3_asr_swift_tpu_torch.models.kokoro import phonemizer as p_ph

TOL = 1e-5
WAV_TOL = 1e-4
CFG = p_model.config_tiny()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The LSTM loops are chains of small ops: with several test workers on
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


def pt(tree, dtype=torch.float32):
    return params_from_jax(tree, "cpu", dtype)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err
    return err


@pytest.fixture(scope="module")
def tree():
    return jitter(p_model.init_kokoro_params(np.random.default_rng(0), CFG),
                  np.random.default_rng(1))


@pytest.fixture(scope="module")
def models(tree):
    return jx(tree), pt(tree)


def rnd(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def replay_noise(seed, n_f0, cfg=CFG):
    """The source noise ``kokoro_forward`` draws from ``PRNGKey(seed)``."""
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    shape = (1, n_f0 * cfg.samples_per_frame, cfg.nb_harmonics + 1)
    return np.asarray(jax.random.normal(k1, shape))


def test_configs_match_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(j_model.config_tiny())
    assert dataclasses.asdict(p_model.CONFIG_82M) == dataclasses.asdict(j_model.CONFIG_82M)
    assert CFG.samples_per_frame == j_model.config_tiny().samples_per_frame
    assert p_model.CONFIG_82M.samples_per_frame == 600


def test_initializer_tree_matches_reference():
    mine = p_model.init_kokoro_params(np.random.default_rng(0), CFG)
    ref = jax.eval_shape(lambda: j_model.init_kokoro_params(jax.random.PRNGKey(0), CFG))
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [(p, np.shape(a)) for p, a in flat_m] == [(p, a.shape) for p, a in flat_r]


def test_albert_matches(models):
    jp, pp = models
    ids = np.random.default_rng(2).integers(1, 178, (2, 16)).astype(np.int32)
    mask = np.arange(16)[None] < np.array([[16], [9]])
    want = j_albert.albert_forward(jp["bert"], CFG.albert, jnp.asarray(ids), jnp.asarray(mask))
    got = p_albert.albert_forward(pp["bert"], CFG.albert, torch.from_numpy(ids),
                                  torch.from_numpy(mask))
    close(got, want)


def _ids(n_valid, t=16, seed=3):
    ids = np.zeros((1, t), np.int32)
    ids[0, :n_valid] = np.random.default_rng(seed).integers(1, 178, n_valid)
    return ids, np.arange(t)[None] < n_valid


def test_text_encode_matches(models):
    jp, pp = models
    ids, valid = _ids(11)
    want = j_model.text_encode(jp["text_encoder"], CFG, jnp.asarray(ids), 11, jnp.asarray(valid))
    got = p_model.text_encode(pp["text_encoder"], CFG, torch.from_numpy(ids), 11,
                              torch.from_numpy(valid))
    close(got, want)


@pytest.mark.parametrize("n_valid", [1, 5, 12, 16])
def test_masked_bilstm_matches(models, n_valid):
    jp, pp = models
    x = rnd(4, 2, 16, CFG.hidden_dim + CFG.style_dim)
    want = j_model._bilstm(jp["predictor"]["lstm"], jnp.asarray(x), jnp.asarray(n_valid))
    got = p_model._bilstm(pp["predictor"]["lstm"], torch.from_numpy(x), torch.tensor(n_valid))
    close(got, want)


def test_duration_encode_matches(models):
    jp, pp = models
    ids, valid = _ids(9)
    d_en = rnd(5, 1, 16, CFG.hidden_dim)
    style = rnd(6, 1, CFG.style_dim)
    want = j_model.duration_encode(jp["predictor"], CFG, jnp.asarray(d_en), jnp.asarray(style),
                                   9, jnp.asarray(valid))
    got = p_model.duration_encode(pp["predictor"], CFG, torch.from_numpy(d_en),
                                  torch.from_numpy(style), 9, torch.from_numpy(valid))
    close(got, want)


def test_prosody_f0n_matches(models):
    jp, pp = models
    en = rnd(7, 1, 24, CFG.hidden_dim + CFG.style_dim)
    en[:, 19:] = 0.0
    style = rnd(8, 1, CFG.style_dim)
    want = j_model.prosody_f0n(jp["predictor"], CFG, jnp.asarray(en), jnp.asarray(style),
                               jnp.asarray(19))
    got = p_model.prosody_f0n(pp["predictor"], CFG, torch.from_numpy(en),
                              torch.from_numpy(style), torch.tensor(19))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("which", [("predictor", "F0", 0), ("predictor", "F0", 1),
                                   ("decoder", "decode", 3), ("decoder", "encode", None)])
@pytest.mark.parametrize("n_valid", [None, 7])
def test_adain_resblk_matches(models, which, n_valid):
    jp, pp = models
    top, name, i = which
    jb, pb = jp[top][name], pp[top][name]
    if i is not None:
        jb, pb = jb[i], pb[i]
    upsample = "pool" in jb
    cin = jb["norm1"]["fc"]["kernel"].shape[1] // 2
    x = rnd(9, 1, 10, cin)
    style = rnd(10, 1, CFG.style_dim)
    want = j_model._adain_resblk(jnp.asarray(x), jb, jnp.asarray(style), upsample=upsample,
                                 n_valid=n_valid)
    got = p_model._adain_resblk(torch.from_numpy(x), pb, torch.from_numpy(style),
                                upsample=upsample, n_valid=n_valid)
    close(got, want)


def test_generator_resblock1_and_transposed_convs_match(models):
    jp, pp = models
    jg, pg = jp["decoder"]["generator"], pp["decoder"]["generator"]
    style = rnd(11, 1, CFG.style_dim)
    x = rnd(12, 1, 9, jg["ups"][0]["kernel"].shape[1])
    close(p_model._conv_transpose_same(torch.from_numpy(x), pg["ups"][0], 2),
          j_model._conv_transpose_same(jnp.asarray(x), jg["ups"][0], 2))
    h = rnd(13, 1, 9, jg["resblocks"][0]["convs1"][0]["kernel"].shape[1])
    close(p_model._adain_resblock1(torch.from_numpy(h), pg["resblocks"][0],
                                   torch.from_numpy(style), CFG.resblock_dilations, n_valid=6),
          j_model._adain_resblock1(jnp.asarray(h), jg["resblocks"][0], jnp.asarray(style),
                                   CFG.resblock_dilations, n_valid=6))


def test_harmonic_source_matches_given_the_same_noise(models):
    """The source's STFT within 1e-5 of max |ref| as complex values and as
    magnitudes. Its phases (atan2) part only where the imaginary part is a
    rounding residual: the edge frames, whose reflect-padded, hann-windowed
    samples are symmetric, so every imaginary part cancels to a residual
    whose sign (and so ±π where the real part is negative) follows the sum
    order."""
    jp, pp = models
    nb = CFG.gen_istft_n_fft // 2 + 1
    f0 = np.abs(rnd(14, 1, 20, scale=80.0))
    f0[0, :3] = 0.0                                            # unvoiced frames too
    want = np.asarray(J_SOURCE(jp["decoder"]["generator"], CFG, jnp.asarray(f0),
                               jax.random.PRNGKey(5)), np.float64)
    got = P_SOURCE(pp["decoder"]["generator"], CFG, torch.from_numpy(f0),
                   torch.from_numpy(replay_noise(5, 20))).numpy().astype(np.float64)
    close(got[..., :nb], want[..., :nb])
    close(got[..., :nb] * np.exp(1j * got[..., nb:]), want[..., :nb] * np.exp(1j * want[..., nb:]))
    parted = np.argwhere(np.abs(got[..., nb:] - want[..., nb:]) > 1e-3)
    assert set(parted[:, 1]) <= {0, got.shape[1] - 1}, parted
    for b, f, k in parted:
        assert abs(abs(got[b, f, nb + k] - want[b, f, nb + k]) - 2 * np.pi) < 1e-5


J_SOURCE, P_SOURCE = j_model._harmonic_source, p_model._harmonic_source


@pytest.fixture(scope="module")
def snapped_sources():
    """Both packages' harmonic source with the edge frames' phases set to
    their exact values (0, or π where the real part is negative), so the
    syntheses compare what follows from the rest of the arithmetic."""
    nb = CFG.gen_istft_n_fft // 2 + 1

    def snap_j(p, cfg, f0, key):
        s = J_SOURCE(p, cfg, f0, key)
        edge = s[:, jnp.asarray([0, -1]), nb:]
        return s.at[:, jnp.asarray([0, -1]), nb:].set(
            jnp.where(jnp.abs(edge) > np.pi / 2, np.float32(np.pi), 0.0))

    def snap_p(p, cfg, f0, noise):
        s = P_SOURCE(p, cfg, f0, noise).clone()
        edge = s[:, [0, -1], nb:]
        s[:, [0, -1], nb:] = torch.where(edge.abs() > np.pi / 2, np.float32(np.pi), 0.0).to(s.dtype)
        return s

    mp = pytest.MonkeyPatch()
    mp.setattr(j_model, "_harmonic_source", snap_j)
    mp.setattr(p_model, "_harmonic_source", snap_p)
    yield
    mp.undo()


def test_gen_istft_matches():
    n_bins = CFG.gen_istft_n_fft // 2 + 1
    spec = np.exp(rnd(15, 1, 33, n_bins, scale=0.5))
    phase = np.sin(rnd(16, 1, 33, n_bins))
    want = j_model._gen_istft(jnp.asarray(spec), jnp.asarray(phase), CFG)
    got = p_model._gen_istft(torch.from_numpy(spec), torch.from_numpy(phase), CFG)
    close(got, want)


def test_reference_source_is_twice_the_generator_length(models):
    """A fault of the reference the port keeps (ROADMAP §3): the harmonic
    source repeats the 2F-point F0 curve by samples_per_frame, so its STFT
    has twice the frames of the generator's spectrum (F = 10 frames: 20
    F0 points, 161 source frames, 81 generator frames)."""
    jp, pp = models
    n_frames = 10
    f0 = np.abs(rnd(17, 1, 2 * n_frames, scale=80.0))
    spf, hop = CFG.samples_per_frame, CFG.gen_istft_hop
    ref = J_SOURCE(jp["decoder"]["generator"], CFG, jnp.asarray(f0), jax.random.PRNGKey(0))
    got = P_SOURCE(pp["decoder"]["generator"], CFG, torch.from_numpy(f0),
                                   torch.from_numpy(replay_noise(0, 2 * n_frames)))
    gen_frames = n_frames * spf // hop + 1                    # the generator's spectrum
    for src in (np.asarray(ref), got.numpy()):
        assert src.shape[1] == 2 * n_frames * spf // hop + 1 == 161
        assert gen_frames == 81 and src.shape[1] == 2 * gen_frames - 1


def _forward_inputs(n_valid=9, t=16, speed=1.0, seed=0):
    ids, _ = _ids(n_valid, t, seed=20 + seed)
    ref_s = rnd(21 + seed, 1, 2 * CFG.style_dim)
    return ids, ref_s, speed


@pytest.fixture(scope="module")
def forward_pair(models, snapped_sources):
    """Both packages' kokoro_forward on one input, with the same noise."""
    jp, pp = models
    ids, ref_s, speed = _forward_inputs()
    max_frames = 16 * 6
    fwd = jax.jit(lambda p, ids, n, s, sp, key: j_model.kokoro_forward(
        p, CFG, ids, n, s, sp, key, max_frames=max_frames))
    want = fwd(jp, jnp.asarray(ids), jnp.asarray(9, jnp.int32), jnp.asarray(ref_s),
               jnp.asarray(speed, jnp.float32), jax.random.PRNGKey(3))
    noise = torch.from_numpy(replay_noise(3, 2 * max_frames))
    got = p_model.kokoro_forward(pp, CFG, torch.from_numpy(ids), 9, torch.from_numpy(ref_s),
                                 torch.tensor(speed), noise, max_frames)
    return want, got, (ids, ref_s, speed, noise, max_frames)


def test_durations_and_total_identical(forward_pair):
    want, got, _ = forward_pair
    assert int(got[1]) == int(want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_alignment_and_decoder_input_match(models, forward_pair):
    """The aligned prosody features, F0/N and the generator's input."""
    jp, pp = models
    _, _, (ids, ref_s, speed, _, max_frames) = forward_pair
    en, fmask, tok_idx, total, pred_dur, dur, valid = p_model.predict_alignment(
        pp, CFG, torch.from_numpy(ids), 9, torch.from_numpy(ref_s), torch.tensor(speed),
        max_frames)
    s_pros = torch.from_numpy(ref_s[:, CFG.style_dim:])
    f0, n = p_model.prosody_f0n(pp["predictor"], CFG, en, s_pros, total)
    jf0, jn = j_model.prosody_f0n(jp["predictor"], CFG, jnp.asarray(en.numpy()),
                                  jnp.asarray(s_pros.numpy()), jnp.asarray(int(total)))
    close(f0, jf0)
    close(n, jn)
    asr = rnd(22, 1, max_frames, CFG.hidden_dim) * fmask.numpy()
    s_dec = ref_s[:, :CFG.style_dim]
    x, nv = p_model.decoder_input(pp["decoder"], CFG, torch.from_numpy(asr), f0, n,
                                  torch.from_numpy(s_dec), total)
    # the reference's decoder up to the generator, step by step
    jd = jp["decoder"]
    jf = j_model._conv_same(jnp.asarray(f0.numpy())[..., None], jd["F0_conv"], stride=2)
    jnn = j_model._conv_same(jnp.asarray(n.numpy())[..., None], jd["N_conv"], stride=2)
    ja = jnp.asarray(asr)
    jxx = j_model._adain_resblk(jnp.concatenate([ja, jf, jnn], -1), jd["encode"],
                                jnp.asarray(s_dec), n_valid=int(total))
    res = j_model._conv_same(ja, jd["asr_res"])
    for i, blk in enumerate(jd["decode"]):
        jxx = j_model._adain_resblk(jnp.concatenate([jxx, res, jf, jnn], -1), blk,
                                    jnp.asarray(s_dec), upsample=i == 3, n_valid=int(total))
    close(x, jxx)
    assert int(nv) == 2 * int(total)


def test_waveform_matches(forward_pair):
    want, got, _ = forward_pair
    close(got[0], want[0], WAV_TOL)


def test_phonemizer_copies_give_identical_ids():
    texts = {
        "en": ["The birch canoe slid on the smooth planks.", "It's 25 past 3, isn't it?",
               "Hello world! Reading, walked, and jumping dogs."],
        "zh": ["你好。", "ni3 hao3 shi4", "mā lǜ"],
        "ja": ["こんにちは。", "カタカナ", "シャッー"],
        "hi": ["नमस्ते।", "नमस्ते"],
        "ko": ["안녕", "안녕 하세요"],
    }
    for lang, items in texts.items():
        for text in items:
            want = j_ph.phonemes_to_ids(j_ph.phonemize(text, lang))
            got = p_ph.phonemes_to_ids(p_ph.phonemize(text, lang))
            assert got == want, (lang, text)


@pytest.fixture(scope="module")
def tiny_pair(tree, snapped_sources):
    """Both packages' KokoroTTS over the tree, the port's source noise
    swapped for the reference's draw."""
    ref = j_model.KokoroTTS(CFG, jx(tree))
    port = p_model.KokoroTTS(CFG, tree, device="cpu")
    port._source_noise = lambda seed, n_f0: torch.from_numpy(replay_noise(seed, n_f0))
    return ref, port


@pytest.mark.parametrize("text,speed", [("hello there", 1.0),
                                        ("the quick brown fox jumps over the dog", 1.0),
                                        ("hello there", 1.5)])
def test_synthesize_matches_reference(tiny_pair, text, speed):
    """End to end through phonemizer, bucket, frame budget and trim_and_fade,
    across two buckets and two speeds."""
    ref, port = tiny_pair
    want = ref.synthesize(text, speed=speed, seed=4)
    got = port.synthesize(text, speed=speed, seed=4)
    assert got.sample_rate == want.sample_rate == 24000
    assert len(got.samples) == len(want.samples) > 0
    close(got.samples, want.samples, WAV_TOL)
    assert port.last_budget["spoken_frames"] * CFG.samples_per_frame == len(got.samples)


def test_voices_and_errors(tiny_pair):
    _, port = tiny_pair
    assert port.available_voices == ["af_heart"]
    with pytest.raises(KeyError):
        port.synthesize("hi", voice="nope")
    table = np.random.default_rng(3).standard_normal((510, 1, 2 * CFG.style_dim)).astype(np.float32)
    port.voices["pack"] = table
    np.testing.assert_array_equal(port._ref_s("pack", 7), table[6, 0])


def _kokoro_state_dict(cfg, seed=0):
    """A tiny checkpoint in the published kokoro-v1_0.pth naming (module
    state-dicts, weight-norm pairs, DataParallel prefixes), as
    ``tests/test_kokoro.py`` builds it."""
    a = cfg.albert
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    def wn(w):
        return {"weight_g": w.norm(dim=tuple(range(1, w.ndim)), keepdim=True), "weight_v": w}

    def lstm_sd(prefix, i, h, out):
        for s in ("", "_reverse"):
            out[f"{prefix}.weight_ih_l0{s}"] = t(4 * h, i)
            out[f"{prefix}.weight_hh_l0{s}"] = t(4 * h, h)
            out[f"{prefix}.bias_ih_l0{s}"] = t(4 * h)
            out[f"{prefix}.bias_hh_l0{s}"] = t(4 * h)

    def conv_sd(prefix, cout, cin, k, out, bias=True):
        for key, v in wn(t(cout, cin, k)).items():
            out[f"{prefix}.{key}"] = v
        if bias:
            out[f"{prefix}.bias"] = t(cout)

    def resblk_sd(prefix, cin, cout, sty, out, upsample=False):
        out[f"{prefix}.norm1.fc.weight"] = t(cin * 2, sty)
        out[f"{prefix}.norm1.fc.bias"] = t(cin * 2)
        conv_sd(f"{prefix}.conv1", cout, cin, 3, out)
        out[f"{prefix}.norm2.fc.weight"] = t(cout * 2, sty)
        out[f"{prefix}.norm2.fc.bias"] = t(cout * 2)
        conv_sd(f"{prefix}.conv2", cout, cout, 3, out)
        if cin != cout:
            conv_sd(f"{prefix}.conv1x1", cout, cin, 1, out, bias=False)
        if upsample:
            conv_sd(f"{prefix}.pool", cin, 1, 3, out)

    def resblock1_sd(prefix, ch, kern, sty, n_dil, out):
        for j in range(n_dil):
            conv_sd(f"{prefix}.convs1.{j}", ch, ch, kern, out)
            conv_sd(f"{prefix}.convs2.{j}", ch, ch, kern, out)
            for n in ("adain1", "adain2"):
                out[f"{prefix}.{n}.{j}.fc.weight"] = t(ch * 2, sty)
                out[f"{prefix}.{n}.{j}.fc.bias"] = t(ch * 2)
            out[f"{prefix}.alpha1.{j}"] = 1.0 + t(1, ch, 1)
            out[f"{prefix}.alpha2.{j}"] = 1.0 + t(1, ch, 1)

    base = "encoder.albert_layer_groups.0.albert_layers.0"
    bert = {
        "embeddings.word_embeddings.weight": t(a.vocab_size, a.embedding_size),
        "embeddings.position_embeddings.weight": t(a.max_position_embeddings, a.embedding_size),
        "embeddings.token_type_embeddings.weight": t(2, a.embedding_size),
        "embeddings.LayerNorm.weight": 1.0 + t(a.embedding_size),
        "embeddings.LayerNorm.bias": t(a.embedding_size),
        "encoder.embedding_hidden_mapping_in.weight": t(a.hidden_size, a.embedding_size),
        "encoder.embedding_hidden_mapping_in.bias": t(a.hidden_size),
    }
    for name in ("attention.query", "attention.key", "attention.value", "attention.dense"):
        bert[f"{base}.{name}.weight"] = t(a.hidden_size, a.hidden_size)
        bert[f"{base}.{name}.bias"] = t(a.hidden_size)
    for name in ("attention.LayerNorm", "full_layer_layer_norm"):
        bert[f"{base}.{name}.weight"] = 1.0 + t(a.hidden_size)
        bert[f"{base}.{name}.bias"] = t(a.hidden_size)
    bert[f"{base}.ffn.weight"] = t(a.intermediate_size, a.hidden_size)
    bert[f"{base}.ffn.bias"] = t(a.intermediate_size)
    bert[f"{base}.ffn_output.weight"] = t(a.hidden_size, a.intermediate_size)
    bert[f"{base}.ffn_output.bias"] = t(a.hidden_size)

    d, sty = cfg.hidden_dim, cfg.style_dim
    predictor = {}
    for i in range(cfg.n_dur_layers):
        lstm_sd(f"text_encoder.lstms.{2 * i}", d + sty, d // 2, predictor)
        predictor[f"text_encoder.lstms.{2 * i + 1}.fc.weight"] = t(d * 2, sty)
        predictor[f"text_encoder.lstms.{2 * i + 1}.fc.bias"] = t(d * 2)
    lstm_sd("lstm", d + sty, d // 2, predictor)
    predictor["duration_proj.linear_layer.weight"] = t(cfg.max_dur, d)
    predictor["duration_proj.linear_layer.bias"] = t(cfg.max_dur)
    lstm_sd("shared", d + sty, d // 2, predictor)
    for tower in ("F0", "N"):
        resblk_sd(f"{tower}.0", d, d, sty, predictor)
        resblk_sd(f"{tower}.1", d, d // 2, sty, predictor, upsample=True)
        resblk_sd(f"{tower}.2", d // 2, d // 2, sty, predictor)
        predictor[f"{tower}_proj.weight"] = t(1, d // 2, 1)
        predictor[f"{tower}_proj.bias"] = t(1)

    text_encoder = {"embedding.weight": t(cfg.vocab_size, d)}
    for i in range(3):
        conv_sd(f"cnn.{i}.0", d, d, cfg.text_kernel, text_encoder)
        text_encoder[f"cnn.{i}.1.gamma"] = 1.0 + t(d)
        text_encoder[f"cnn.{i}.1.beta"] = t(d)
    lstm_sd("lstm", d, d // 2, text_encoder)

    dec, ch0 = cfg.decoder_dim, cfg.upsample_initial
    n_dil, n_up, n_k = len(cfg.resblock_dilations), len(cfg.upsample_rates), len(cfg.resblock_kernels)
    stft_ch = cfg.gen_istft_n_fft + 2
    decoder = {}
    for name in ("F0_conv", "N_conv"):
        conv_sd(name, 1, 1, 3, decoder)
    resblk_sd("encode", d + 2, dec, sty, decoder)
    for i in range(3):
        resblk_sd(f"decode.{i}", dec + 2 + cfg.asr_res_dim, dec, sty, decoder)
    resblk_sd("decode.3", dec + 2 + cfg.asr_res_dim, ch0, sty, decoder, upsample=True)
    conv_sd("asr_res.0", cfg.asr_res_dim, d, 1, decoder)
    decoder["generator.m_source.l_linear.weight"] = t(1, cfg.nb_harmonics + 1)
    decoder["generator.m_source.l_linear.bias"] = t(1)
    for i in range(n_up):
        c_cur = ch0 // (2 ** (i + 1))
        width = 2 * int(np.prod(cfg.upsample_rates[i + 1:])) if i + 1 < n_up else 1
        decoder[f"generator.noise_convs.{i}.weight"] = t(c_cur, stft_ch, width)
        decoder[f"generator.noise_convs.{i}.bias"] = t(c_cur)
        nk = 7 if i + 1 < n_up else (11 if n_k > 1 else cfg.resblock_kernels[-1])
        resblock1_sd(f"generator.noise_res.{i}", c_cur, nk, sty, n_dil, decoder)
        for key, v in wn(t(ch0 // (2 ** i), c_cur, cfg.upsample_kernels[i])).items():
            decoder[f"generator.ups.{i}.{key}"] = v
        decoder[f"generator.ups.{i}.bias"] = t(c_cur)
        for j, kern in enumerate(cfg.resblock_kernels):
            resblock1_sd(f"generator.resblocks.{i * n_k + j}", c_cur, kern, sty, n_dil, decoder)
    conv_sd("generator.conv_post", stft_ch, ch0 // (2 ** n_up), 7, decoder)
    return {
        "bert": bert,
        "bert_encoder": {"weight": t(d, a.hidden_size), "bias": t(d)},
        "predictor": {f"module.{k}": v for k, v in predictor.items()},
        "text_encoder": {f"module.{k}": v for k, v in text_encoder.items()},
        "decoder": {f"module.{k}": v for k, v in decoder.items()},
    }


def test_convert_and_from_pretrained(tmp_path, monkeypatch, snapped_sources):
    """A ``.pth`` in the published layout: the port's converter gives the
    reference's tree, and ``from_pretrained(dir)`` loads it with its voice
    pack and synthesizes as the reference does over the same tree."""
    torch.save(_kokoro_state_dict(CFG), tmp_path / "kokoro-tiny.pth")
    (tmp_path / "voices").mkdir()
    pack = torch.from_numpy(rnd(30, 510, 1, 2 * CFG.style_dim, scale=0.3))
    torch.save(pack, tmp_path / "voices" / "af_test.pt")
    want = j_convert.convert_checkpoint(tmp_path, CFG)
    got = p_convert.convert_checkpoint(tmp_path, CFG)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    voices = p_convert.load_voices(tmp_path)
    np.testing.assert_array_equal(voices["af_test"], j_convert.load_voices(tmp_path)["af_test"])

    monkeypatch.setattr(p_model, "CONFIG_82M", CFG)
    monkeypatch.setattr(p_convert, "convert_checkpoint",
                        lambda d, cfg=CFG, f=p_convert.convert_checkpoint: f(d, cfg))
    port = p_model.KokoroTTS.from_pretrained(str(tmp_path), device="cpu")
    assert port.available_voices == ["af_test"]
    port._source_noise = lambda seed, n_f0: torch.from_numpy(replay_noise(seed, n_f0))
    ref = j_model.KokoroTTS(CFG, jx(want), voices=j_convert.load_voices(tmp_path))
    a = port.synthesize("hello", voice="af_test", seed=2)
    b = ref.synthesize("hello", voice="af_test", seed=2)
    assert len(a.samples) == len(b.samples) > 0
    close(a.samples, b.samples, WAV_TOL)
