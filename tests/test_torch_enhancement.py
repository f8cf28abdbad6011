"""The port's DeepFilterNet3 against the JAX package's, on the CPU.

Both packages take the same numpy weights (drawn by the port's
``init_dfn3_params``; batch-norm statistics randomized so the folding is
exercised), in fp32:

- ``dfn3_forward`` (mask, deep-filter coefficients, LSNR) within 1e-5 of
  max |ref|;
- the window, DFT bases and ERB banks equal to the reference's (the same
  numpy code); ``_featurize`` and ``_istft_ola`` within 1e-5;
- ``SpeechEnhancer.enhance`` within 1e-5 of the reference's output, at 48
  and at 16 kHz;
- ``StreamingEnhancer`` (pushes of 5 hops, then flush) within 1e-5 of the
  port's batch output, with O(1) normalization states as in the
  reference's exactness test (the libDF default unit-norm init of
  1e-3..1e-4 divides the first frames' spectra by ~1e-2, which turns
  rounding of differently batched products into larger differences; that
  case is held to the reference's own 2e-2), and reset reproducing;
- the port's copy of ``convert.py`` maps an upstream-layout state dict to
  the reference's tree leaf for leaf, and ``from_pretrained`` reads it
  from a directory.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_asr_swift_tpu.models.enhancement import SpeechEnhancer as JaxEnhancer
from qwen3_asr_swift_tpu.models.enhancement import convert as jconvert
from qwen3_asr_swift_tpu.models.enhancement import dfn3 as jdfn3
from qwen3_asr_swift_tpu.models.enhancement import model as jmodel
from qwen3_asr_swift_tpu_torch.core.params import params_from_jax
from qwen3_asr_swift_tpu_torch.models.enhancement import (SpeechEnhancer, StreamingEnhancer,
                                                          init_dfn3_params)
from qwen3_asr_swift_tpu_torch.models.enhancement import convert as pconvert
from qwen3_asr_swift_tpu_torch.models.enhancement import dfn3 as pdfn3
from qwen3_asr_swift_tpu_torch.models.enhancement import model as pmodel

TOL = 1e-5
HOP = pmodel.HOP


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def random_params(seed=0):
    rng = np.random.default_rng(seed)
    params = init_dfn3_params(rng)

    def bn(node):
        if isinstance(node, dict):
            if "bn" in node:
                o = node["bn"]["scale"].shape[0]
                node["bn"] = {"scale": rng.uniform(0.5, 1.5, o).astype(np.float32),
                              "bias": rng.uniform(-0.2, 0.2, o).astype(np.float32),
                              "mean": rng.uniform(-0.2, 0.2, o).astype(np.float32),
                              "var": rng.uniform(0.5, 2.0, o).astype(np.float32)}
            for v in node.values():
                bn(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                bn(v)

    bn(params)
    return params


@pytest.fixture(scope="module")
def params():
    return random_params()


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_dfn3_forward_matches(params):
    rng = np.random.default_rng(1)
    t = 17
    erb = rng.standard_normal((t, pdfn3.NB_ERB)).astype(np.float32)
    spec = rng.standard_normal((t, pdfn3.NB_DF, 2)).astype(np.float32)
    want = jdfn3.dfn3_forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(erb),
                              jnp.asarray(spec))
    got = pdfn3.dfn3_forward(params_from_jax(params, "cpu", torch.float32),
                             torch.from_numpy(erb), torch.from_numpy(spec))
    for name, g, w in zip(("mask", "coefs", "lsnr"), got, want):
        assert g.shape == w.shape, name
        assert rel(g.numpy(), w) < TOL, (name, rel(g.numpy(), w))


def test_dsp_constants_are_the_references():
    np.testing.assert_array_equal(pmodel.vorbis_window(), jmodel.vorbis_window())
    for got, want in zip(pmodel._dft(), jmodel._dft()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pmodel._idft(), jmodel._idft()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pmodel.erb_filterbank(), jmodel.erb_filterbank())
    np.testing.assert_array_equal(pmodel.erb_inverse_filterbank(),
                                  jmodel.erb_inverse_filterbank())
    np.testing.assert_array_equal(pmodel._erb_fb_widths()[2], jmodel._erb_fb_widths()[2])
    np.testing.assert_array_equal(pmodel.default_mean_norm_init(),
                                  jmodel.default_mean_norm_init())
    np.testing.assert_array_equal(pmodel.default_unit_norm_init(),
                                  jmodel.default_unit_norm_init())


def test_features_and_istft_match():
    rng = np.random.default_rng(2)
    frames = (0.3 * rng.standard_normal((12, pmodel.N_FFT))).astype(np.float32)
    mean0, unit0 = pmodel.default_mean_norm_init(), pmodel.default_unit_norm_init()
    want = jmodel._featurize(jnp.asarray(frames), jnp.asarray(mean0), jnp.asarray(unit0))
    bases = pmodel._Bases(torch.device("cpu"))
    got = pmodel._featurize(bases, torch.from_numpy(frames), torch.from_numpy(mean0),
                            torch.from_numpy(unit0))
    for name, g, w in zip(("erb_n", "spec_n", "re", "im", "mean", "unit"), got, want):
        assert g.shape == w.shape, name
        assert rel(g.numpy(), w) < TOL, (name, rel(g.numpy(), w))
    re, im = got[2], got[3]
    mem = (0.1 * rng.standard_normal(pmodel.N_FFT - HOP)).astype(np.float32)
    w_samples, w_mem = jmodel._istft_ola(jnp.asarray(re.numpy()), jnp.asarray(im.numpy()),
                                         jnp.asarray(mem))
    g_samples, g_mem = pmodel._istft_ola(bases, re, im, torch.from_numpy(mem))
    assert rel(g_samples.numpy(), w_samples) < TOL
    assert rel(g_mem.numpy(), w_mem) < TOL


@pytest.mark.parametrize("rate,seconds", [(48000, 0.75), (16000, 0.5)])
def test_enhance_matches_reference(params, rate, seconds):
    rng = np.random.default_rng(3)
    t = np.arange(int(rate * seconds)) / rate
    audio = (0.3 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.standard_normal(len(t))
             ).astype(np.float32)
    want = JaxEnhancer(params).enhance(audio, rate)
    got = SpeechEnhancer(params, device="cpu").enhance(audio, rate)
    assert got.sample_rate == want.sample_rate == 48000
    assert len(got.samples) == len(want.samples)
    assert rel(got.samples, want.samples) < TOL, rel(got.samples, want.samples)


def test_streamed_equals_batch(params):
    m = SpeechEnhancer(params, device="cpu",
                       mean_norm_init=np.zeros(pdfn3.NB_ERB, np.float32),
                       unit_norm_init=np.ones(pdfn3.NB_DF, np.float32))
    audio = (0.3 * np.random.default_rng(4).standard_normal(HOP * 24 + 123)).astype(np.float32)
    batch = m.enhance(audio, pmodel.SR).samples
    s = StreamingEnhancer(m, chunk_samples=HOP * 5)
    streamed = np.concatenate([s.push(audio[:1000]), s.push(audio[1000:]), s.flush()])
    streamed = streamed[: len(batch)]
    assert len(streamed) == len(batch)
    assert rel(streamed, batch) < TOL, rel(streamed, batch)


def test_streamed_close_with_default_norm_state(params):
    m = SpeechEnhancer(params, device="cpu")
    audio = (0.3 * np.random.default_rng(5).standard_normal(HOP * 16)).astype(np.float32)
    batch = m.enhance(audio, pmodel.SR).samples
    s = StreamingEnhancer(m, chunk_samples=HOP * 3)
    streamed = np.concatenate([s.push(audio), s.flush()])[: len(batch)]
    assert rel(streamed, batch) < 2e-2
    s.reset()
    again = np.concatenate([s.push(audio), s.flush()])[: len(batch)]
    np.testing.assert_array_equal(again, streamed)


def test_push_exact_and_tail_contracts(params):
    s = StreamingEnhancer(SpeechEnhancer(params, device="cpu"))
    with pytest.raises(ValueError):
        s.push_exact(np.zeros(HOP + 1, np.float32))
    s.push(np.zeros(HOP // 2, np.float32))
    with pytest.raises(ValueError):
        s.push_exact(np.zeros(HOP, np.float32))
    with pytest.raises(ValueError):
        s.push_tail(np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        StreamingEnhancer(SpeechEnhancer(params, device="cpu"), chunk_samples=HOP + 1)


def upstream_state_dict(params):
    """The upstream DeepFilterNet3 naming of a canonical tree: each
    Conv2dNormAct a Sequential (a leading pad for the causal convs, the
    conv, the pointwise conv, the BatchNorm), transposed convs as torch
    (I, O/g, kH, kW) with frequency taps unflipped, GRUs as nn.GRU."""
    sd = {}

    def block(prefix, p, causal, transpose=False):
        i = 1 if causal else 0
        w = p["w"][..., ::-1] if transpose else p["w"]
        sd[f"{prefix}.{i}.weight"] = np.ascontiguousarray(w)
        if "b" in p:
            sd[f"{prefix}.{i}.bias"] = p["b"]
        if "pw" in p:
            i += 1
            sd[f"{prefix}.{i}.weight"] = p["pw"]
        if "bn" in p:
            i += 1
            sd[f"{prefix}.{i}.weight"] = p["bn"]["scale"]
            sd[f"{prefix}.{i}.bias"] = p["bn"]["bias"]
            sd[f"{prefix}.{i}.running_mean"] = p["bn"]["mean"]
            sd[f"{prefix}.{i}.running_var"] = p["bn"]["var"]

    def gru(prefix, p):
        sd[f"{prefix}.linear_in.0.weight"] = p["lin_in"]
        for k, layer in enumerate(p["gru"]):
            sd[f"{prefix}.gru.weight_ih_l{k}"] = layer["wi"]
            sd[f"{prefix}.gru.weight_hh_l{k}"] = layer["wh"]
            sd[f"{prefix}.gru.bias_ih_l{k}"] = layer["bi"]
            sd[f"{prefix}.gru.bias_hh_l{k}"] = layer["bh"]
        if "lin_out" in p:
            sd[f"{prefix}.linear_out.0.weight"] = p["lin_out"]

    enc, erb, df = params["enc"], params["erb_dec"], params["df_dec"]
    for name in ("erb_conv0", "df_conv0"):
        block(f"enc.{name}", enc[name], causal=True)
    for name in ("erb_conv1", "erb_conv2", "erb_conv3", "df_conv1"):
        block(f"enc.{name}", enc[name], causal=False)
    sd["enc.df_fc_emb.0.weight"] = enc["df_fc_emb"]
    gru("enc.emb_gru", enc["emb_gru"])
    sd["enc.lsnr_fc.0.weight"] = enc["lsnr"]["w"]
    sd["enc.lsnr_fc.0.bias"] = enc["lsnr"]["b"]
    gru("erb_dec.emb_gru", erb["emb_gru"])
    for name in ("conv3p", "convt3", "conv2p", "conv1p", "conv0p", "conv0_out"):
        block(f"erb_dec.{name}", erb[name], causal=False)
    for name in ("convt2", "convt1"):
        block(f"erb_dec.{name}", erb[name], causal=False, transpose=True)
    gru("df_dec.df_gru", df["df_gru"])
    sd["df_dec.df_out.0.weight"] = df["df_out"]
    block("df_dec.df_convp", df["df_convp"], causal=True)
    return sd


def test_converted_state_dict_matches_reference(params, tmp_path):
    from safetensors.numpy import save_file

    sd = upstream_state_dict(params)
    got, want = pconvert.map_dfn3_state_dict(sd), jconvert.map_dfn3_state_dict(sd)
    got_leaves, want_leaves = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert len(got_leaves) == len(want_leaves) > 80
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)
    # the canonical tree comes back (pads shifted, taps re-flipped)
    for g, w in zip(got_leaves, jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, w)

    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(tmp_path / "model.safetensors"))
    mean0 = np.linspace(-50.0, -80.0, pdfn3.NB_ERB).astype(np.float32)
    np.savez(tmp_path / "auxiliary.npz", mean_norm_state=mean0)
    loaded = SpeechEnhancer.from_pretrained(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(loaded.mean_norm_init, mean0)
    np.testing.assert_array_equal(loaded.unit_norm_init, pmodel.default_unit_norm_init())
    audio = (0.2 * np.random.default_rng(6).standard_normal(HOP * 12)).astype(np.float32)
    direct = SpeechEnhancer(params, device="cpu", mean_norm_init=mean0).enhance(audio, 48000)
    np.testing.assert_array_equal(loaded.enhance(audio, 48000).samples, direct.samples)
    with pytest.raises(FileNotFoundError):
        SpeechEnhancer.from_pretrained("no/such/dfn3-checkpoint", device="cpu",
                                       cache_dir=str(tmp_path / "cache"), offline_mode=True)
