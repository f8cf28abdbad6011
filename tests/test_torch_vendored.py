"""The port's own copies of the JAX package's jax-free host code.

The port imports nothing of ``qwen3_asr_swift_tpu``; it carries copies of
what it needs. Each copy is held here against its original on seeded
numpy inputs, with exact equality (the copies are the same numpy code),
and one AST walk shows that no module of the port, nor ``chip_smoke.py``,
imports the JAX package.
"""

import ast
import importlib
import inspect
import os
from pathlib import Path

import numpy as np
import pytest

from qwen3_asr_swift_tpu.audio import companding as j_comp
from qwen3_asr_swift_tpu.audio import io as j_io
from qwen3_asr_swift_tpu.core import types as j_types
from qwen3_asr_swift_tpu.core import weights as j_weights
from qwen3_asr_swift_tpu.ops import mel as j_mel
from qwen3_asr_swift_tpu.serving import batching as j_batching
from qwen3_asr_swift_tpu.serving import dispatch as j_dispatch
from qwen3_asr_swift_tpu.tokenizers import bpe as j_bpe
from qwen3_asr_swift_tpu_torch.audio import companding as p_comp
from qwen3_asr_swift_tpu_torch.audio import io as p_io
from qwen3_asr_swift_tpu_torch.core import types as p_types
from qwen3_asr_swift_tpu_torch.core import weights as p_weights
from qwen3_asr_swift_tpu_torch.ops import mel as p_mel
from qwen3_asr_swift_tpu_torch.serving import batching as p_batching
from qwen3_asr_swift_tpu_torch.serving import dispatch as p_dispatch
from qwen3_asr_swift_tpu_torch.tokenizers import bpe as p_bpe

# the audio packages export the function ``resample`` over the module's name
j_resample = importlib.import_module("qwen3_asr_swift_tpu.audio.resample")
p_resample = importlib.import_module("qwen3_asr_swift_tpu_torch.audio.resample")

REPO = Path(__file__).resolve().parent.parent
# the encoders' size threshold above which the JAX package may take its
# native C++ path; the port is numpy at every size
NATIVE_MIN = 65536


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_mlx_matches(bits):
    w = np.random.default_rng(bits).standard_normal((48, 256)).astype(np.float32)
    for got, want in zip(p_weights.quantize_mlx(w, bits, 64), j_weights.quantize_mlx(w, bits, 64)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [(), (80, 201, 16000, 400), (128, 257, 16000, 512, 20.0, 7600.0)])
def test_mel_filterbank_matches(args):
    np.testing.assert_array_equal(p_mel.mel_filterbank(*args), j_mel.mel_filterbank(*args))


@pytest.mark.parametrize("args", [(), (256, 256)])
def test_windowed_dft_matches(args):
    for got, want in zip(p_mel.windowed_dft(*args), j_mel.windowed_dft(*args)):
        np.testing.assert_array_equal(got, want)


def test_mel_config_num_frames_and_reflect_pad_match():
    pc, jc = p_mel.MelConfig(), j_mel.MelConfig()
    assert [getattr(pc, f) for f in pc.__dataclass_fields__] == \
        [getattr(jc, f) for f in jc.__dataclass_fields__]
    assert pc.n_freqs == jc.n_freqs
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 5, 199, 200, 201, 16000, 16001, 12_000_000 + 7):
        assert p_mel.num_frames(pc, n) == j_mel.num_frames(jc, n), n
    for n in (2, 3, 150, 201, 4000):
        audio = rng.standard_normal((2, n)).astype(np.float32)
        np.testing.assert_array_equal(p_mel.reflect_pad_np(audio, 200),
                                      j_mel.reflect_pad_np(audio, 200))


@pytest.mark.parametrize("name", ["mulaw_encode_np", "pcm4_encode_np", "dpcm4_encode_np"])
@pytest.mark.parametrize("n", [2048, 2 * NATIVE_MIN + 256])
def test_wire_encoders_match_numpy_path(monkeypatch, name, n):
    """Below and above the native threshold: the port's numpy encoder is
    the JAX package's numpy path, bit for bit (the JAX native codec is
    held against that same path by tests/test_companding.py)."""
    monkeypatch.setattr(j_comp, "_native_lib", False)
    x = (0.3 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    x[0, :4] = [1.5, -1.5, 0.0, 1e-9]
    got, want = getattr(p_comp, name)(x), getattr(j_comp, name)(x)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    assert p_comp.MU == j_comp.MU and p_comp.PCM4_BLOCK == j_comp.PCM4_BLOCK


@pytest.mark.parametrize("rates", [(8000, 16000), (44100, 16000), (16000, 16000), (22050, 24000)])
def test_resample_matches(rates):
    x = np.random.default_rng(1).standard_normal(4410).astype(np.float32)
    np.testing.assert_array_equal(p_resample.resample(x, *rates), j_resample.resample(x, *rates))


def test_resample_rejects_bad_rates():
    with pytest.raises(ValueError):
        p_resample.resample(np.zeros(4, np.float32), 0, 16000)


def test_wav_round_trip_matches(tmp_path):
    rng = np.random.default_rng(2)
    x = np.clip(0.4 * rng.standard_normal(3001), -1.2, 1.2).astype(np.float32)
    body = p_io.wav_bytes(x, 22050)
    assert body == j_io.wav_bytes(x, 22050)
    (got, rate), (want, want_rate) = p_io.read_wav(body), j_io.read_wav(body)
    assert rate == want_rate == 22050
    np.testing.assert_array_equal(got, want)
    path = tmp_path / "x.wav"
    p_io.write_wav(path, x, 8000)
    np.testing.assert_array_equal(p_io.load_audio(path, 16000)[0], j_io.load_audio(path, 16000)[0])
    for bad in (b"", b"RIFF" + bytes(40), body[:20] + b"\xff" * 30):
        with pytest.raises(p_io.WAVError):
            p_io.read_wav(bad)


def test_sample_conversions_match():
    rng = np.random.default_rng(3)
    for x in (rng.integers(-32768, 32767, 64, dtype=np.int16),
              rng.integers(0, 255, 64, dtype=np.uint8), rng.standard_normal(64)):
        np.testing.assert_array_equal(p_types.to_float32(x), j_types.to_float32(x))
    y = 1.5 * rng.standard_normal(64).astype(np.float32)
    np.testing.assert_array_equal(p_types.to_pcm16(y), j_types.to_pcm16(y))


def _toy_vocab():
    enc = j_bpe._bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256)}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"), ("Ġ", "w"), ("Ġw", "o")]
    for i, (a, b) in enumerate(merges):
        vocab[a + b] = 256 + i
    return vocab, merges, {"<|im_start|>": 400, "<|im_end|>": 401}


@pytest.mark.parametrize("text", ["hello world", "<|im_start|>hello<|im_end|> wo 123",
                                  "héllo, 世界! 4567", ""])
def test_bpe_tokenizer_matches(text):
    vocab, merges, special = _toy_vocab()
    port, ref = p_bpe.BPETokenizer(vocab, merges, special), j_bpe.BPETokenizer(vocab, merges, special)
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.encode(text, allow_special=False) == ref.encode(text, allow_special=False)
    assert port.decode(ids) == ref.decode(ids) and port.decode(ids) == text
    assert port.decode(ids, skip_special=True) == ref.decode(ids, skip_special=True)
    assert port.vocab_size == ref.vocab_size


@pytest.mark.parametrize("port,ref,names", [
    (p_dispatch, j_dispatch, ["DispatchGate", "set_thread_nice", "thread_nice", "gate_slot"]),
    (p_batching, j_batching, ["ContinuousBatcher"]),
    (p_io, j_io, ["read_wav", "wav_bytes", "load_audio"]),
    (p_bpe, j_bpe, ["BPETokenizer"]),
    (p_comp, j_comp, ["dpcm4_encode_np"]),
])
def test_copied_code_is_the_original(port, ref, names):
    """Whole copies keep their originals' source, so a fix to one shows as
    a difference here. (dpcm4_encode_np: only the native branch is cut.)"""
    for name in names:
        got, want = inspect.getsource(getattr(port, name)), inspect.getsource(getattr(ref, name))
        if name == "dpcm4_encode_np":
            cut = want[want.index("    lib = _native()"):want.index("    lead = x.shape[:-1]")]
            want = want.replace(cut, "")
        assert got == want, name


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_nothing_of_the_jax_package():
    files = sorted((REPO / "qwen3_asr_swift_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = {}
    for f in files:
        mods = [m for m in _imported_modules(f)
                if m == "qwen3_asr_swift_tpu" or m.startswith("qwen3_asr_swift_tpu.")
                or m == "jax" or m.startswith("jax.")]
        if mods:
            bad[os.path.relpath(f, REPO)] = mods
    assert not bad, bad
