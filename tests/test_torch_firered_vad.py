"""FireRedVAD (``qwen3_asr_swift_tpu_torch/models/firered_vad``) against its
JAX twin on the CPU.

One numpy-drawn tree at ``config_tiny()`` (``rorder`` 1: the look-ahead
memory conv runs; every leaf jittered) goes to both packages. Modules
within 1e-5 of max |reference| (fp32 both), whole outputs within 1e-4,
segments equal. Both of ``frame_probabilities``' paths are held: one
pass up to ``max_frames`` (the reference pads to a bucket and runs its
fused program, or runs one eager pass past its largest bucket; the port
runs the same fused function unpadded) and the chunked path above
``max_frames``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.firered_vad import model as j_model
from qwen3_asr_swift_tpu_torch.models.firered_vad import model as p_model

TOL = 1e-5
WHOLE_TOL = 1e-4
CFG = p_model.config_tiny()


def jcfg(cfg):
    return j_model.FireRedVADConfig(**dataclasses.asdict(cfg))


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
    return jitter(p_model.init_firered_params(np.random.default_rng(0), CFG),
                  np.random.default_rng(1))


def pair(tree, cfg=CFG):
    return (j_model.FireRedVAD(jcfg(cfg), jax.tree_util.tree_map(jnp.asarray, tree)),
            p_model.FireRedVAD(cfg, tree, device="cpu"))


def noisy(n, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    gate = (np.sin(2 * np.pi * 0.9 * t) > 0.2).astype(np.float32)
    return (0.4 * gate * np.sin(2 * np.pi * 210 * t)
            + 0.03 * rng.standard_normal(n)).astype(np.float32)


def test_lfr_stack_matches():
    feats = np.random.default_rng(2).standard_normal((17, 5)).astype(np.float32)
    for m, n in ((3, 1), (5, 1), (4, 2)):
        np.testing.assert_array_equal(
            p_model.lfr_stack(torch.from_numpy(feats), m, n).numpy(),
            np.asarray(j_model.lfr_stack(jnp.asarray(feats), m, n)))


@pytest.mark.parametrize("causal", [True, False])
def test_memory_conv_matches(causal):
    x = np.random.default_rng(4).standard_normal((2, 31, 8)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal((4, 1, 8)).astype(np.float32)
    close(p_model._memory_conv(torch.from_numpy(x), torch.from_numpy(w), causal),
          j_model._memory_conv(jnp.asarray(x), jnp.asarray(w), causal))


@pytest.mark.parametrize("valid_rows", [None, 23])
def test_fsmn_forward_matches(tree, valid_rows):
    ref, port = pair(tree)
    feats = np.random.default_rng(6).standard_normal((2, 40, 60)).astype(np.float32)
    want = j_model.fsmn_forward(ref.params, jcfg(CFG), jnp.asarray(feats), valid_rows)
    got = p_model.fsmn_forward(port.params, CFG, torch.from_numpy(feats), valid_rows)
    close(got, want)


@pytest.mark.parametrize("n", [4000, 16001, 31997])
def test_bucket_path_matches(tree, n):
    """Up to ``max_frames`` rows in a bucket: the reference pads to the
    bucket and runs its fused program; the port's one unpadded pass equals
    it, and the port's fused function on the reference's padded audio
    gives the same valid rows."""
    ref, port = pair(tree)
    audio = noisy(n)
    want = ref.frame_probabilities(audio)
    got = port.frame_probabilities(audio)
    assert port.last_path == ("single", 1)
    close(got, want, WHOLE_TOL)
    bucket = ref._bucket_samples(n)
    staged = np.zeros(bucket, np.float32)
    staged[:n] = audio
    padded = p_model.fused_vad_forward(port.params, CFG, torch.from_numpy(staged), n)
    close(padded[: len(got)], got)


def test_chunked_path_matches_and_equals_one_pass(tree):
    """Above ``max_frames`` (cut to 40) the rows go through overlapping
    chunks: equal to the reference's chunked path and to one pass."""
    cfg = dataclasses.replace(CFG, max_frames=40)
    ref, port = pair(tree, cfg)
    audio = noisy(32000)
    want = ref.frame_probabilities(audio)
    got = port.frame_probabilities(audio)
    assert port.last_path == ("chunked", 5)
    close(got, want, WHOLE_TOL)
    one = pair(tree)[1]
    close(got, one.frame_probabilities(audio), TOL)


def test_single_pass_above_the_buckets_matches(tree):
    """Past the reference's largest bucket (cut to 1 s) and within
    ``max_frames``: the reference's eager pass equals the port's one
    pass."""
    ref, port = pair(tree)
    ref._buckets_s = (1,)
    audio = noisy(24000)
    close(port.frame_probabilities(audio), ref.frame_probabilities(audio), WHOLE_TOL)
    assert port.last_path == ("single", 1)


def test_detect_speech_matches(tree):
    """Smoothed probabilities, one threshold set across the widest gap near
    their median (at least 1e-5 clear of every frame): the segments equal
    the reference's."""
    audio = noisy(48000)
    probs = pair(tree)[0].frame_probabilities(audio)
    smooth = np.unique(np.convolve(probs, np.ones(5) / 5, mode="same"))
    lo, hi = int(0.4 * len(smooth)), int(0.6 * len(smooth))
    i = lo + int(np.argmax(np.diff(smooth[lo:hi + 1])))
    thr = float(0.5 * (smooth[i] + smooth[i + 1]))
    assert np.abs(smooth - thr).min() > 1e-5
    cfg = dataclasses.replace(CFG, speech_threshold=thr, min_speech_s=0.05, min_silence_s=0.05)
    ref, port = pair(tree, cfg)
    want, got = ref.detect_speech(audio), port.detect_speech(audio)
    assert len(want) >= 2
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in want]
    assert port.detect_speech(np.zeros(100, np.float32)) == []


def test_init_random_and_checkpoint(tmp_path):
    """``init_random`` keeps ``config_tiny()``; a FunASR-named checkpoint at
    the published widths (80 mels, the converter's base; 2 blocks, taps
    4 + 2), written here, converts through the copied converter with its
    dims inferred."""
    from safetensors.numpy import save_file

    m = p_model.FireRedVAD.init_random(device="cpu")
    assert m.cfg == CFG and m.device.type == "cpu"
    cfg = dataclasses.replace(p_model.CONFIG_FIRERED, num_blocks=2, lorder=4, rorder=2)
    tree = p_model.init_firered_params(np.random.default_rng(3), cfg)
    flat = {}
    for name, key in (("in1", "in_linear1"), ("in2", "in_linear2"), ("out1", "out_linear1"),
                      ("out2", "out_linear2")):
        flat[f"encoder.{key}.linear.weight"] = np.ascontiguousarray(tree[name]["kernel"].T)
        flat[f"encoder.{key}.linear.bias"] = tree[name]["bias"]
    for i, b in enumerate(tree["blocks"]):
        flat[f"encoder.fsmn.{i}.linear.linear.weight"] = np.ascontiguousarray(
            b["linear"]["kernel"].T)
        flat[f"encoder.fsmn.{i}.fsmn_block.conv_left.weight"] = np.ascontiguousarray(
            b["conv_left"][:, 0, :].T)[:, None, :, None]
        flat[f"encoder.fsmn.{i}.fsmn_block.conv_right.weight"] = np.ascontiguousarray(
            b["conv_right"][:, 0, :].T)[:, None, :, None]
        flat[f"encoder.fsmn.{i}.affine.linear.weight"] = np.ascontiguousarray(
            b["affine"]["kernel"].T)
        flat[f"encoder.fsmn.{i}.affine.linear.bias"] = b["affine"]["bias"]
    save_file(flat, str(tmp_path / "vad.safetensors"))
    loaded = p_model.FireRedVAD.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.cfg == cfg
    audio = noisy(8000)
    close(loaded.frame_probabilities(audio),
          p_model.FireRedVAD(cfg, tree, device="cpu").frame_probabilities(audio), TOL)


def test_reference_converter_squeezes_a_one_tap_memory_away():
    """A fault of the reference that the port's copy keeps: ``_memory``
    squeezes a torch memory weight [D, 1, taps, 1], so a one-tap look-ahead
    (``rorder`` 1, as ``config_tiny()`` has) loses its taps axis and the
    transpose fails. Both converters raise alike."""
    from qwen3_asr_swift_tpu.models.firered_vad import convert as j_convert
    from qwen3_asr_swift_tpu_torch.models.firered_vad import convert as p_convert

    w = np.ones((8, 1, 1, 1), np.float32)
    for conv in (j_convert, p_convert):
        with pytest.raises(IndexError):
            conv._memory(w)
        assert conv._memory(np.ones((8, 1, 2, 1), np.float32)).shape == (2, 1, 8)
