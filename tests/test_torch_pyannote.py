"""Pyannote segmentation-3.0 (``qwen3_asr_swift_tpu_torch/models/pyannote``)
against its JAX twin on the CPU.

One numpy-drawn tree at ``config_tiny()`` (every leaf jittered, with the
affine instance norms a converted checkpoint carries) goes to both
packages. Modules within 1e-5 of max |reference| (fp32 both), whole
outputs within 1e-4, segments equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.pyannote import model as j_model
from qwen3_asr_swift_tpu_torch.models.pyannote import model as p_model

TOL = 1e-5
WHOLE_TOL = 1e-4
CFG = p_model.config_tiny()
J_CFG = j_model.SegmentationConfig(**dataclasses.asdict(CFG))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The LSTM loop is a chain of small ops: with several test workers on
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


def make_tree(cfg, seed=0):
    tree = p_model.init_segmentation_params(np.random.default_rng(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    tree["wav_norm"] = {"scale": np.ones(1, np.float32), "bias": np.zeros(1, np.float32)}
    for p in tree["conv"]:
        c = p["kernel"].shape[-1]
        p["norm"] = {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}
    return jitter(tree, rng)


@pytest.fixture(scope="module")
def tree():
    return make_tree(CFG)


@pytest.fixture(scope="module")
def models(tree):
    ref = j_model.PyannoteSegmentation(J_CFG, jax.tree_util.tree_map(jnp.asarray, tree))
    port = p_model.PyannoteSegmentation(CFG, tree, device="cpu")
    return ref, port


def speech(seconds, seed=3):
    """Tones with noise, silent gaps between them."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    gate = (np.sin(2 * np.pi * 0.7 * t) > 0).astype(np.float32)
    return (0.3 * gate * np.sin(2 * np.pi * 180 * t)
            + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def test_sincnet_matches(models):
    ref, port = models
    wave = np.stack([speech(1.0, 1), speech(1.0, 2)])
    want = j_model.sincnet(ref.params, J_CFG, jnp.asarray(wave))
    got = p_model.sincnet(port.params, CFG, torch.from_numpy(wave))
    close(got, want)
    assert got.shape[1] == 57    # (16000 - 65)//10 + 1 → //3 → -4 → //3 → -4 → //3


def test_bilstm_layer_matches(models):
    ref, port = models
    x = np.random.default_rng(4).standard_normal((3, 23, 6)).astype(np.float32)
    pf, pb = ref.params["lstm_fwd"][0], ref.params["lstm_bwd"][0]
    want = jnp.concatenate([j_model._lstm_scan(pf, jnp.asarray(x)),
                            j_model._lstm_scan(pb, jnp.asarray(x), reverse=True)], axis=-1)
    got = p_model.bilstm(port.params["lstm_fwd"][0], port.params["lstm_bwd"][0],
                         torch.from_numpy(x))
    close(got, want)


def test_two_layer_forward_matches():
    """Four windows through a 2-layer, 2-linear config: the posteriors and
    their per-speaker sums within 1e-5."""
    cfg = dataclasses.replace(CFG, lstm_layers=2, linear_layers=2)
    tree = make_tree(cfg, seed=5)
    wave = np.stack([speech(1.0, s) for s in range(4)])
    want = j_model.segmentation_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                        j_model.SegmentationConfig(**dataclasses.asdict(cfg)),
                                        jnp.asarray(wave))
    port = p_model.PyannoteSegmentation(cfg, tree, device="cpu")
    got = p_model.segmentation_forward(port.params, cfg, torch.from_numpy(wave))
    close(got, want)
    close(p_model.powerset_to_speakers(got), j_model.powerset_to_speakers(want))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("seconds", [0.6, 2.3, 3.0])
def test_speaker_activity_matches(models, seconds):
    """Windows of 1 s at a 0.5 s step, the last one shorter than its hop
    (2.3 s) or the clip shorter than a window (0.6 s): the overlap-averaged
    tracks within 1e-4."""
    ref, port = models
    audio = speech(seconds)
    want = ref.speaker_activity(audio)
    got = port.speaker_activity(audio)
    close(got, want, WHOLE_TOL)
    starts, windows = port.windows(audio)
    assert port.last_loop == {"windows": len(starts), "frames": 57, "iterations": 57}
    assert port.frame_duration == ref.frame_duration


def test_speaker_activity_resamples(models):
    ref, port = models
    audio = speech(1.7)[::2].copy()
    close(port.speaker_activity(audio, 8000), ref.speaker_activity(audio, 8000), WHOLE_TOL)


def mid_threshold(values, q):
    """A threshold near quantile ``q``: midway across the widest gap between
    neighbouring values within 0.1 of it, and its distance to the nearest
    value."""
    v = np.unique(np.asarray(values, np.float64))
    lo, hi = int((q - 0.1) * (len(v) - 1)), int((q + 0.1) * (len(v) - 1))
    i = lo + int(np.argmax(np.diff(v[lo: hi + 1])))
    thr = 0.5 * (v[i] + v[i + 1])
    return thr, np.abs(v - thr).min()


def test_detect_speech_matches(models):
    """Any-speaker activity, hysteresis at thresholds set between the
    probabilities (each at least 1e-5 clear of every frame), merged and
    filtered: the segments equal the reference's."""
    ref, port = models
    audio = speech(4.0)
    probs = ref.speaker_activity(audio).max(axis=-1)
    onset, m_on = mid_threshold(probs, 0.6)
    offset, m_off = mid_threshold(probs, 0.4)
    assert min(m_on, m_off) > 1e-5, (m_on, m_off)
    kw = dict(onset=onset, offset=offset, min_speech_s=0.05, min_silence_s=0.05)
    want = j_model.PyannoteVAD(ref, **kw).detect_speech(audio)
    got = p_model.PyannoteVAD(port, **kw).detect_speech(audio)
    assert len(want) >= 2
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in want]
    close(p_model.PyannoteVAD(port).speech_probabilities(audio), probs, WHOLE_TOL)


def test_binarize_matches():
    rng = np.random.default_rng(9)
    probs = rng.uniform(0, 1, 300).astype(np.float32)
    for kw in ({}, {"min_speech_s": 0.05}, {"min_silence_s": 0.04, "min_speech_s": 0.02}):
        assert p_model.binarize(probs, 0.017, **kw) == j_model.binarize(probs, 0.017, **kw)


def test_init_random_and_device_rule():
    m = p_model.PyannoteVAD.init_random(device="cpu")
    assert m.segmentation.device.type == "cpu" and m.segmentation.cfg == CFG
    assert isinstance(m.detect_speech(np.zeros(16000, np.float32)), list)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            p_model.PyannoteVAD.init_random()


def test_from_pretrained_reads_a_local_checkpoint(tmp_path, tree):
    """A pyannote-named state dict at SEGMENTATION_30's widths, written
    here, loads through the copied converter: affine norms, summed LSTM
    biases, every layer."""
    from safetensors.numpy import save_file

    cfg = p_model.SEGMENTATION_30
    full = p_model.init_segmentation_params(np.random.default_rng(2), cfg)
    flat = {"sincnet.wav_norm1d.weight": np.ones(1, np.float32),
            "sincnet.wav_norm1d.bias": np.zeros(1, np.float32)}
    for i, p in enumerate(full["conv"]):
        flat[f"sincnet.conv1d.{i}.weight"] = np.ascontiguousarray(p["kernel"].transpose(2, 1, 0))
        flat[f"sincnet.conv1d.{i}.bias"] = p["bias"]
        c = p["kernel"].shape[-1]
        flat[f"sincnet.norm1d.{i}.weight"] = np.full(c, 1.1, np.float32)
        flat[f"sincnet.norm1d.{i}.bias"] = np.full(c, 0.1, np.float32)
    for i, (pf, pb) in enumerate(zip(full["lstm_fwd"], full["lstm_bwd"])):
        for sfx, p in (("", pf), ("_reverse", pb)):
            flat[f"lstm.weight_ih_l{i}{sfx}"] = np.ascontiguousarray(p["wx"].T)
            flat[f"lstm.weight_hh_l{i}{sfx}"] = np.ascontiguousarray(p["wh"].T)
            flat[f"lstm.bias_ih_l{i}{sfx}"] = np.full(p["bias"].shape, 0.01, np.float32)
    for i, p in enumerate(full["linear"]):
        flat[f"linear.{i}.weight"] = np.ascontiguousarray(p["kernel"].T)
        flat[f"linear.{i}.bias"] = p["bias"]
    flat["classifier.weight"] = np.ascontiguousarray(full["classifier"]["kernel"].T)
    flat["classifier.bias"] = full["classifier"]["bias"]
    save_file(flat, str(tmp_path / "model.safetensors"))
    m = p_model.PyannoteSegmentation.from_pretrained(str(tmp_path), device="cpu")
    assert m.cfg == cfg and len(m.params["lstm_fwd"]) == 4
    np.testing.assert_array_equal(m.params["lstm_bwd"][3]["bias"].numpy(),
                                  np.full(512, 0.01, np.float32))
    np.testing.assert_array_equal(m.params["conv"][0]["norm"]["scale"].numpy(),
                                  np.full(80, 1.1, np.float32))
