"""The port's native wire codec (``qwen3_asr_swift_tpu_torch/runtime``).

- the port's library, built with g++ from its own copy of
  ``wire_codec.cpp``, and the JAX package's library give byte-identical
  output on all three encoders;
- the port's native output against its numpy path, as the reference's
  tests hold the reference's: pcm4 and dpcm4 byte-identical, µ-law within
  one code on under 1 % of samples (the native µ-law rounds through a
  lookup table);
- below ``_NATIVE_MIN_SAMPLES`` numpy runs, from it on the native codec
  (counted in ``WIRE_NATIVE_CALLS``);
- the library's name is keyed on its source, so an edited source builds
  a new library; a failed build raises.
"""

import shutil

import numpy as np
import pytest

from qwen3_asr_swift_tpu.audio import companding as j_comp
from qwen3_asr_swift_tpu_torch.audio import companding as p_comp
from qwen3_asr_swift_tpu_torch.runtime import native

ENCODERS = ["mulaw_encode_np", "pcm4_encode_np", "dpcm4_encode_np"]


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")


def speech_like(shape, seed):
    """AR(1) low-passed noise with a slow envelope, clipped past ±1 in a
    few places."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(shape).astype(np.float64)
    x = np.empty(shape, np.float64)
    acc = np.zeros(shape[:-1])
    for i in range(shape[-1]):
        acc = 0.97 * acc + 0.1 * e[..., i]
        x[..., i] = acc
    env = 0.2 + 0.8 * np.abs(np.sin(np.arange(shape[-1]) / 16000 * 2 * np.pi * 1.3))
    x = (x / np.abs(x).max() * 0.6 * env).astype(np.float32)
    x[..., :6] = [1.5, -1.5, 1.0, -1.0, 0.0, 1e-9]
    return x


def as_bytes(out):
    return [a.view(np.uint8) for a in (out if isinstance(out, tuple) else (out,))]


def numpy_path(module, fn, x):
    saved = module._native_lib
    module._native_lib = False
    try:
        return fn(x)
    finally:
        module._native_lib = saved


@pytest.fixture(scope="module")
def signal():
    return speech_like((2, p_comp._NATIVE_MIN_SAMPLES), seed=3)


@pytest.mark.parametrize("name", ENCODERS)
def test_port_library_matches_the_jax_library(signal, name):
    assert j_comp._native() is not None and p_comp._native() is not None
    got, want = getattr(p_comp, name)(signal), getattr(j_comp, name)(signal)
    for g, w in zip(as_bytes(got), as_bytes(want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["pcm4_encode_np", "dpcm4_encode_np"])
def test_native_4bit_is_byte_identical_to_numpy(signal, name):
    fn = getattr(p_comp, name)
    for g, w in zip(as_bytes(fn(signal)), as_bytes(numpy_path(p_comp, fn, signal))):
        np.testing.assert_array_equal(g, w)


def test_native_mulaw_within_one_code_of_numpy(signal):
    nat = p_comp.mulaw_encode_np(signal).astype(int)
    ref = numpy_path(p_comp, p_comp.mulaw_encode_np, signal).astype(int)
    d = np.abs(nat - ref)
    assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("name", ENCODERS)
def test_threshold_picks_the_path(name):
    fn = getattr(p_comp, name)
    small = speech_like((1, 2048), seed=4)
    big = speech_like((1, p_comp._NATIVE_MIN_SAMPLES), seed=5)
    p_comp._native()
    p_comp.WIRE_NATIVE_CALLS.reset()
    fn(small)
    assert p_comp.WIRE_NATIVE_CALLS.value == 0
    fn(big)
    assert p_comp.WIRE_NATIVE_CALLS.value == 1
    fn(big.astype(np.float64))   # only float32 takes the native codec
    assert p_comp.WIRE_NATIVE_CALLS.value == 1


def test_edited_source_builds_a_new_library(tmp_path):
    src = tmp_path / "wire_codec.cpp"
    shutil.copy(native.SOURCE, src)
    first = native.build_library(src, tmp_path / "build")
    assert native.build_library(src, tmp_path / "build") == first and native.build_info["cached"]
    src.write_text(src.read_text() + "\n// edited\n")
    second = native.build_library(src, tmp_path / "build")
    assert second != first and second.exists() and not native.build_info["cached"]


def test_failed_build_raises(tmp_path):
    src = tmp_path / "wire_codec.cpp"
    src.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library(src, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_build_reaches_the_encoder(monkeypatch):
    """Where g++ exists, a broken build is an error at the encoder, not a
    silent numpy fallback."""
    def broken(*args, **kwargs):
        raise RuntimeError("g++ failed on wire_codec.cpp")

    monkeypatch.setattr(native, "build_library", broken)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(p_comp, "_native_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        p_comp.dpcm4_encode_np(np.zeros((1, p_comp._NATIVE_MIN_SAMPLES), np.float32))
