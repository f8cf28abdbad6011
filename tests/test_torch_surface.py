"""The rest of the JAX package's public surface, in the port.

- a guard: every public top-level name of every module of the JAX package,
  and every public method of its classes, has a counterpart of the same
  name in the port's module of the same path, but for an explicit
  allow-list whose entries each give their reason (and one renamed
  counterpart, ``resample_jax`` → ``resample_torch``). A new gap fails;
- ``MelFrontend`` within 1e-4 of the JAX ``MelFrontend`` and of the
  float64 golden, as the reference is (both fp32 programs lie up to 5e-5
  from the golden), on the cases of JAX ``tests/test_mel.py`` (across
  buckets, under 2 samples), its ``device_call`` and ``reflect_pad``;
  ``log_mel_reference`` against the golden fixture at the JAX test's
  tolerance;
- ``resample_torch`` within 1e-5 of max |ref| of ``resample_jax``;
- the masks equal to the reference's, and ``sdpa_reference``'s copy;
- ``profile_trace`` writes a trace and logs, as JAX
  ``tests/test_foundation.py`` holds its own, and the trace holds the
  program's spans;
- ``build_default_registry``, ``main`` and the card defaults of the new
  entry points.
"""

import ast
import importlib
import inspect
import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.audio.resample import resample_jax
from qwen3_asr_swift_tpu.ops import attention as j_att
from qwen3_asr_swift_tpu.ops import mel as j_mel
from qwen3_asr_swift_tpu_torch.audio import resample_torch
from qwen3_asr_swift_tpu_torch.ops import attention as p_att
from qwen3_asr_swift_tpu_torch.ops import mel as p_mel

REPO = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = REPO / "qwen3_asr_swift_tpu", REPO / "qwen3_asr_swift_tpu_torch"

#: public names of the JAX package that the port carries under another name
COUNTERPARTS = {("audio/resample.py", "resample_jax"): "resample_torch"}

_INIT = ("the family's init_random draws the whole tree through the model module's "
         "init_*_params (numpy) or init_*_params_on_device (a torch.Generator on the card)")

#: the JAX package's public names with no counterpart in the port, and why
ALLOWED = {
    ("core/__init__.py", "enable_persistent_cache"):
        "XLA's compilation cache; the port runs eager PyTorch with nothing to compile, and "
        "its kernels build once into the git-ignored build directory",
    ("ops/attention_pallas.py", "<module>"):
        "the Pallas decode attention; K3 (csrc/decode_attn_int8.cu through "
        "ops/attention_int8.py::decode_attention_int8) replaces it",
    ("ops/quant.py", "quant_matmul_xla"):
        "picks XLA's dequantizing route; the port's routes are quant_matmul (plain), "
        "quant_matmul_cuda (K1) and quant_matmul_plane_cuda (K2), chosen by QUANT_KERNEL",
    ("ops/quant.py", "quant_matmul_pallas"):
        "picks the Pallas kernel and its tile (QUANT_PATH, QUANT_TILE_OUT); K1 and K2 replace it",
    ("parallel/mesh.py", "spans_processes"):
        "every port mesh spans processes (one process a device over torch.distributed)",
    ("parallel/mesh.py", "put_global"):
        "device_put of a process-spanning global array; each port rank holds its local shard "
        "(parallel/mesh.py::shard_pytree)",
    ("models/qwen3_asr/beam.py", "build_beam_program"):
        "compiles the jitted beam program; the port's beam_search runs eagerly",
    ("models/firered_vad/model.py", "DEFAULT_BUCKETS_S"):
        "the reference's length buckets for its jitted pass; the port runs one pass of up to "
        "6,000 rows and a chunked path above, with no buckets",
    ("models/cosyvoice/dit.py", "init_dit_params"): _INIT,
    ("models/cosyvoice/dit.py", "init_flow_params"): _INIT,
    ("models/cosyvoice/hift.py", "init_hift_params"): _INIT,
    ("models/enhancement/model.py", "init_dfn_params"): _INIT,
    ("models/kokoro/albert.py", "init_albert_params"): _INIT,
    ("models/qwen3_asr/decoder.py", "init_decoder_params"):
        "core/params.py::init_random_params draws the encoder and decoder (numpy or the card)",
    ("models/qwen3_asr/encoder.py", "init_encoder_params"):
        "core/params.py::init_random_params draws the encoder and decoder (numpy or the card)",
    ("models/vibevoice/diffusion.py", "init_diffusion_params"): _INIT,
    ("models/vibevoice/tokenizer.py", "init_tokenizer_params"): _INIT,
    ("models/voxcpm2/vae.py", "init_vae_params"): _INIT,
    ("models/wakeword/zipformer.py", "init_embed_params"): _INIT,
    ("models/wakeword/zipformer.py", "init_layer_params"): _INIT,
    ("ops/nn.py", "init_linear"): _INIT,
    ("ops/nn.py", "init_conv2d"): _INIT,
}


def _public(path: Path):
    """Public top-level defs, classes and assigned names of a module, and
    each public class's public methods."""
    tree = ast.parse(path.read_text())
    names, methods = [], {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                methods[node.name] = [m.name for m in node.body
                                      if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                                      and not m.name.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for e in target.elts if isinstance(target, ast.Tuple) else [target]:
                    if isinstance(e, ast.Name) and not e.id.startswith("_"):
                        names.append(e.id)
    return names, methods


def surface_gaps():
    gaps = set()
    for f in sorted(JAX_PKG.rglob("*.py")):
        rel = f.relative_to(JAX_PKG)
        if not (PORT_PKG / rel).exists():
            gaps.add((rel.as_posix(), "<module>"))
            continue
        parts = rel.with_suffix("").parts
        parts = parts[:-1] if parts[-1] == "__init__" else parts
        port = importlib.import_module(".".join((PORT_PKG.name,) + parts))
        names, methods = _public(f)
        for name in names:
            got = getattr(port, COUNTERPARTS.get((rel.as_posix(), name), name), None)
            if got is None:
                gaps.add((rel.as_posix(), name))
                continue
            gaps.update((rel.as_posix(), f"{name}.{m}") for m in methods.get(name, [])
                        if not hasattr(got, m))
    return gaps


def test_the_ports_surface_gaps_are_the_allow_list():
    assert surface_gaps() == set(ALLOWED)
    assert all(len(reason) > 20 for reason in ALLOWED.values())
    assert resample_torch.__name__ == COUNTERPARTS[("audio/resample.py", "resample_jax")]


# ---------------------------------------------------------------------------
# MelFrontend, reflect_pad, log_mel_reference
# ---------------------------------------------------------------------------

def sine(freq, seconds, sr=16000, amp=0.5):
    t = np.arange(int(seconds * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def noise(n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def frontends():
    return p_mel.MelFrontend(device="cpu"), j_mel.MelFrontend()


MEL_CASES = {
    "sine 1 s 440 Hz": lambda: sine(440.0, 1.0),
    "sine 2.3 s 1234.5 Hz": lambda: sine(1234.5, 2.3),
    "noise 16321": lambda: noise(16000 + 321, 7),
    "short 800": lambda: sine(440.0, 0.05),
    "one sample": lambda: np.array([0.3], np.float32),
    "no sample": lambda: np.zeros(0, np.float32),
    "two samples": lambda: np.array([0.3, -0.2], np.float32),
    "bucket 10 s": lambda: noise(7 * 16000 + 5, 3),
}


#: |port - reference| and |each - float64 golden|, absolute (the values are
#: O(1)): both fp32 programs lie up to 5e-5 from the float64 golden on these
#: cases (low-power bins whose DFT sums cancel), so they differ by as much;
#: 1e-4 is ``tests/test_torch_frontend.py``'s limit for the same kernel
MEL_TOL = 1e-4


@pytest.mark.parametrize("case", list(MEL_CASES))
def test_mel_frontend_matches_the_reference(frontends, case):
    """``__call__`` within :data:`MEL_TOL` of the JAX ``MelFrontend`` (the
    cases of JAX ``tests/test_mel.py``, lengths across four buckets and
    under 2 samples) and of the float64 per-frame golden, as the reference
    is; the shape the frame count. ``-s`` prints the readings."""
    audio = MEL_CASES[case]()
    port, ref = frontends
    got, want = port(audio), np.asarray(ref(audio))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == (128, p_mel.num_frames(port.cfg, max(len(audio), 2)))
    np.testing.assert_allclose(got, want, atol=MEL_TOL, rtol=0)
    if got.shape[1] and len(audio) >= 2:
        gold = p_mel.log_mel_reference(audio)
        print(f"{case}: port-reference {np.abs(got - want).max():.3e}, port-golden "
              f"{np.abs(got - gold).max():.3e}, reference-golden {np.abs(want - gold).max():.3e}")
        assert np.abs(got - gold).max() <= MEL_TOL and np.abs(want - gold).max() <= MEL_TOL


def test_mel_frontend_bucketing_invariance_and_range():
    audio = sine(300.0, 0.9)
    small = p_mel.MelFrontend(buckets_s=(1, 30), device="cpu")
    big = p_mel.MelFrontend(buckets_s=(10, 30), device="cpu")
    assert np.abs(small(audio) - big(audio)).max() < 1e-5
    out = small(sine(440.0, 1.0))
    assert out.max() - out.min() <= 2.0 + 1e-5
    ref = j_mel.MelFrontend(buckets_s=(1, 30))
    assert p_mel.MelFrontend.DEFAULT_BUCKETS_S == j_mel.MelFrontend.DEFAULT_BUCKETS_S
    for frames in (1, 100, 3000):
        assert small.padded_len_for_frames(frames) == ref.padded_len_for_frames(frames)
        assert small._bucket_for(frames) == ref._bucket_for(frames)
    assert small._bucket_for(5000) == ref._bucket_for(5000) == small.cfg.max_frames


@pytest.mark.parametrize("n", [1, 5, 199, 200, 201, 1000])
def test_reflect_pad_and_device_call_match(n):
    audio = noise(n, n)
    np.testing.assert_array_equal(p_mel.reflect_pad(torch.from_numpy(audio), 200).numpy(),
                                  np.asarray(j_mel.reflect_pad(jnp.asarray(audio), 200)))
    np.testing.assert_array_equal(p_mel.reflect_pad(torch.from_numpy(audio), 200).numpy(),
                                  p_mel.reflect_pad_np(audio, 200))
    if n < 2:
        return
    cfg = p_mel.MelConfig()
    fe = p_mel.MelFrontend(device="cpu")
    n_valid = p_mel.num_frames(cfg, n)
    bucket = fe._bucket_for(n_valid)
    padded = p_mel.reflect_pad(torch.from_numpy(audio), cfg.n_fft // 2)
    padded = torch.nn.functional.pad(padded, (0, fe.padded_len_for_frames(bucket) - len(padded)))
    got = fe.device_call(padded, n_valid, bucket)
    want = j_mel.MelFrontend().device_call(jnp.asarray(padded.numpy()), n_valid, bucket)
    assert got.shape == (cfg.n_mels, bucket)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MEL_TOL, rtol=0)


def test_log_mel_reference_matches_the_golden_fixture():
    with np.load(REPO / "tests" / "fixtures" / "golden_dsp.npz") as z:
        audio, want = z["audio_chirp"], z["whisper_mel"]
    got = p_mel.log_mel_reference(audio)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, j_mel.log_mel_reference(audio))


# ---------------------------------------------------------------------------
# resample_torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rates", [(48000, 16000), (16000, 24000), (44100, 16000),
                                   (16000, 16000)])
def test_resample_torch_matches_resample_jax(rates):
    x = noise(4801, sum(rates) % 97)
    want = np.asarray(resample_jax(x, *rates))
    got = resample_torch(x, *rates, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    batch = resample_torch(torch.from_numpy(np.stack([x, -x])), *rates, num_taps=64,
                           device="cpu")
    np.testing.assert_allclose(batch[1].numpy(), -got.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# masks and sdpa_reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_len,kv_len,offset", [(4, 4, 0), (3, 9, 2), (1, 7, 6), (5, 5, 0)])
def test_masks_match_the_reference(q_len, kv_len, offset):
    got = p_att.causal_mask(q_len, kv_len, offset, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_att.causal_mask(q_len, kv_len,
                                                                            offset)))
    off = torch.tensor(offset)
    np.testing.assert_array_equal(p_att.causal_mask(q_len, kv_len, off, device="cpu").numpy(),
                                  got.numpy())
    for valid in (0, offset, kv_len, torch.tensor(q_len)):
        want = np.asarray(j_att.length_mask(kv_len, int(valid)))
        np.testing.assert_array_equal(p_att.length_mask(kv_len, valid, "cpu").numpy(), want)
        np.testing.assert_array_equal(p_att.decode_step_mask(kv_len, valid, "cpu").numpy(),
                                      np.asarray(j_att.decode_step_mask(kv_len, int(valid))))


@pytest.mark.parametrize("hq,hkv,masked", [(4, 4, False), (4, 2, True), (4, 1, True)])
def test_sdpa_reference_matches_and_holds_sdpa(hq, hkv, masked):
    rng = np.random.default_rng(hq + hkv)
    q = rng.standard_normal((2, hq, 5, 8)).astype(np.float32)
    k = rng.standard_normal((2, hkv, 7, 8)).astype(np.float32)
    v = rng.standard_normal((2, hkv, 7, 8)).astype(np.float32)
    mask = p_att.causal_mask(5, 7, 2, device="cpu") if masked else None
    mask_np = None if mask is None else mask.numpy()
    want = p_att.sdpa_reference(q, k, v, 0.35, mask_np)
    np.testing.assert_array_equal(want, j_att.sdpa_reference(q, k, v, 0.35, mask_np))
    got = p_att.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), 0.35, mask)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# profile_trace
# ---------------------------------------------------------------------------

def test_profile_trace_writes_and_times(tmp_path, caplog):
    """As JAX ``tests/test_foundation.py`` holds its own: a trace directory
    is written, and the wall is logged under the annotation; here the
    directory holds a Chrome trace that names the annotated range."""
    import json

    from qwen3_asr_swift_tpu_torch.core.logging import profile_trace

    d = tmp_path / "trace"
    with caplog.at_level(logging.INFO, logger="speech.Inference"):
        with profile_trace(str(d), "unit"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    traces = list(d.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "unit" in names and "aten::mm" in names
    assert any("profile unit:" in r.getMessage() and str(d) in r.getMessage()
               for r in caplog.records)
    with profile_trace(str(d)):
        torch.zeros(3).sum()
    assert len(list(d.glob("*.pt.trace.json"))) == 2


def test_profile_trace_holds_the_program_spans(tmp_path):
    """The program's spans (``core/trace.py``) of a tiny CPU transcription
    are ranges of the written trace; the tracer's state is restored: on,
    with what it had recorded, or off."""
    import dataclasses
    import json

    from qwen3_asr_swift_tpu_torch.core import trace
    from qwen3_asr_swift_tpu_torch.core.logging import profile_trace
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny

    cfg = config_tiny()
    cfg = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))
    model = Qwen3ASR.init_random(cfg, seed=0, device="cpu", dtype=torch.float32, quant_bits=4,
                                 kv_dtype=torch.int8, audio_buckets_s=(8,), decode_chunk_tokens=3)
    clip = (0.1 * np.random.default_rng(7).standard_normal(16000)).astype(np.float32)
    try:
        trace.enable()
        with trace.span("before"):
            pass
        with profile_trace(str(tmp_path), "tiny"):
            model.transcribe_batch([clip], max_tokens=6)
        assert trace.ON and not trace._annotate
        names = [s.name for s in trace.spans()]
        assert names[0] == "before" and "asr.batch" in names
        (path,) = tmp_path.glob("*.pt.trace.json")
        events = json.loads(path.read_text())["traceEvents"]
        host = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
        assert {"tiny", "asr.batch", "asr.step", "asr.sample", "asr.done_read"} <= host
        trace.disable()
        with profile_trace(str(tmp_path / "off")):
            model.transcribe_batch([clip], max_tokens=6)
        assert not trace.ON and not trace._annotate
        assert "asr.batch" in {s.name for s in trace.spans()}
    finally:
        trace.disable()


# ---------------------------------------------------------------------------
# the server's default registry and entry point; the card defaults
# ---------------------------------------------------------------------------

def test_build_default_registry_and_main(monkeypatch):
    from qwen3_asr_swift_tpu_torch import serving
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR
    from qwen3_asr_swift_tpu_torch.serving import server

    calls = []
    monkeypatch.setattr(Qwen3ASR, "from_pretrained",
                        classmethod(lambda cls, **kw: calls.append(kw) or "model"))
    assert serving.build_default_registry is server.build_default_registry
    reg = server.build_default_registry()
    assert list(reg._loaders) == ["asr"] and calls == []           # lazy
    assert reg._loaders["asr"]() == "model"
    assert calls == [{"decode_chunk_tokens": 15, "device": "cuda"}]
    server.build_default_registry(None, device="cpu")._loaders["asr"]()
    assert calls[-1] == {"decode_chunk_tokens": None, "device": "cpu"}

    seen = {}

    class FakeServer:
        def __init__(self, registry, host, port):
            seen.update(registry=registry, host=host, port=port)

        async def serve_forever(self):
            seen["served"] = True

    monkeypatch.setattr(server, "SpeechServer", FakeServer)
    server.main([])
    assert seen["served"] and (seen["host"], seen["port"]) == ("127.0.0.1", 8321)
    seen["registry"]._loaders["asr"]()
    assert calls[-1] == {"decode_chunk_tokens": 15, "device": "cuda"}
    server.main(["--host", "0.0.0.0", "--port", "9000", "--device", "cpu"])
    assert (seen["host"], seen["port"]) == ("0.0.0.0", 9000)
    seen["registry"]._loaders["asr"]()
    assert calls[-1]["device"] == "cpu"


def test_cli_serve_takes_the_default_registry(monkeypatch):
    from qwen3_asr_swift_tpu_torch import cli
    from qwen3_asr_swift_tpu_torch.serving import server

    seen = {}
    monkeypatch.setattr(server, "build_default_registry",
                        lambda **kw: seen.setdefault("registry", kw) and "registry")

    class FakeServer:
        def __init__(self, registry, **kw):
            seen["given"] = registry

        async def serve_forever(self):
            pass

    monkeypatch.setattr(server, "SpeechServer", FakeServer)
    cli.main(["--device", "cpu", "serve", "--decode-chunk", "7"])
    assert seen["given"] == "registry" and seen["registry"]["decode_chunk_tokens"] == 7
    assert str(seen["registry"]["device"]) == "cpu"


def test_new_entry_points_default_to_the_card(monkeypatch):
    from qwen3_asr_swift_tpu_torch.models.wakeword import zipformer
    from qwen3_asr_swift_tpu_torch.parallel import spawn
    from qwen3_asr_swift_tpu_torch.serving.server import build_default_registry

    for fn, arg in ((spawn, "device"), (zipformer.init_states, "device"),
                    (p_mel.MelFrontend.__init__, "device"), (resample_torch, "device"),
                    (p_att.causal_mask, "device"), (p_att.length_mask, "device"),
                    (p_att.decode_step_mask, "device"), (build_default_registry, "device")):
        assert inspect.signature(fn).parameters[arg].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: p_mel.MelFrontend(), lambda: resample_torch(np.zeros(8), 2, 1),
                 lambda: p_att.causal_mask(2, 2), lambda: p_att.length_mask(2, 1),
                 lambda: p_att.decode_step_mask(2, 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# ---------------------------------------------------------------------------
# host copies: the numpy decoders, configs, weights helpers, KVCache
# ---------------------------------------------------------------------------

def test_dpcm4_numpy_decoder_matches():
    """``dpcm4_decode_np`` inlines the reference's nibble unpacking, so it is
    held by its values (the other host copies by their source,
    ``tests/test_torch_vendored.py``), and against the device decoder."""
    from qwen3_asr_swift_tpu.audio import companding as j_comp
    from qwen3_asr_swift_tpu_torch.audio import companding as p_comp

    x = np.clip(noise(4 * 256, 5) * 5, -1, 1)
    packed, scales2 = j_comp.dpcm4_encode_np(x)
    got = p_comp.dpcm4_decode_np(packed, scales2)
    np.testing.assert_array_equal(got, j_comp.dpcm4_decode_np(packed, scales2))
    np.testing.assert_allclose(
        got, p_comp.dpcm4_decode(torch.from_numpy(packed), torch.from_numpy(scales2)).numpy(),
        atol=1e-6)


def test_param_bytes_and_cache_properties_match():
    """``param_bytes`` over numpy arrays and tensors; ``KVCache.max_len`` and
    ``batch`` on the port's cache layout, float and int8."""
    from qwen3_asr_swift_tpu.core import weights as j_weights
    from qwen3_asr_swift_tpu.ops import kv_cache as j_kv
    from qwen3_asr_swift_tpu_torch.core import weights as p_weights
    from qwen3_asr_swift_tpu_torch.ops import kv_cache as p_kv

    rng = np.random.default_rng(2)
    w, b = rng.standard_normal((8, 128)).astype(np.float32), np.ones(3, np.float16)
    tree = {"a": [w, {"b": b}], "c": (np.zeros(2, np.uint32),), "d": None}
    assert p_weights.param_bytes(tree) == j_weights.param_bytes(tree) == 4096 + 6 + 8
    as_tensors = {"a": [torch.from_numpy(w), {"b": torch.from_numpy(b)}],
                  "c": (torch.zeros(2, dtype=torch.int32),)}
    assert p_weights.param_bytes(as_tensors) == j_weights.param_bytes(tree)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.int8, jnp.int8)):
        got = p_kv.init_cache(2, 3, 2, 11, 8, dtype, device="cpu")
        want = j_kv.init_cache(2, 3, 2, 11, 8, jdtype)
        assert (got.max_len, got.batch) == (want.max_len, want.batch) == (11, 3)
