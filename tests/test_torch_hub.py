"""The model cache (``core/hub.py``) and every ``from_pretrained``'s use of
it, against the JAX package's.

- twin cases: both packages' ``download_weights`` run on caches built alike
  under ``tmp_path`` and on the same stand-in ``huggingface_hub`` (a module
  put in ``sys.modules``; no test reaches the network). The outcomes are
  equal: the path returned, relative to the test's root; the files left
  under it; the stand-in's calls (``repo_id``, ``local_dir``,
  ``allow_patterns``); the recorded sleeps; the progress calls; the type
  and message of what was raised, and of its cause;
- the call arguments: each of the 22 ``from_pretrained`` hands
  ``download_weights`` the reference's arguments (``progress_handler``
  compared as present or absent);
- end to end: a tiny packed Qwen3-ASR checkpoint in the cache under a model
  id, loaded by id offline, gives the tokens of the same checkpoint loaded
  by its directory.
"""

import importlib
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.core import hub as j_hub
from qwen3_asr_swift_tpu_torch.core import hub as p_hub
from qwen3_asr_swift_tpu_torch.core.params import (checkpoint_flat, init_random_params,
                                                    save_checkpoint)
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import model as p_model
from qwen3_asr_swift_tpu_torch.tokenizers.bpe import _bytes_to_unicode

HUBS = {"jax": j_hub, "port": p_hub}
MODEL = "org/Model-1"


class Refused(AssertionError):
    """The stand-in's default: a fetch that no test asked for."""


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Every test here starts online with a stand-in ``huggingface_hub``
    that refuses to fetch, no cache variable and no offline variable."""
    def refuse(**kw):
        raise Refused(f"snapshot_download called: {kw}")

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(snapshot_download=refuse))
    for var in ("QWEN3_CACHE_DIR", "HF_HUB_OFFLINE"):
        monkeypatch.delenv(var, raising=False)


class FakeHub:
    """``snapshot_download`` that fails ``fail`` times, then writes ``files``
    into ``local_dir``."""

    def __init__(self, fail=0, files=("model.safetensors", "config.json")):
        self.fail, self.files, self.calls = fail, files, []

    def snapshot_download(self, repo_id, local_dir, allow_patterns):
        self.calls.append({"repo_id": repo_id, "local_dir": local_dir,
                           "allow_patterns": list(allow_patterns)})
        if self.fail:
            self.fail -= 1
            raise ConnectionError(f"attempt {len(self.calls)}: no route to host")
        for name in self.files:
            (Path(local_dir) / name).write_bytes(b"x")
        return local_dir


def outcome(hub, monkeypatch, root: Path, setup, call, fake: FakeHub):
    """Build ``root`` with ``setup``, run ``call(hub, root, progress)`` with
    ``HOME`` at ``root`` and the stand-in hub, and describe what happened
    with ``root`` written as ``<root>``."""
    root.mkdir()
    setup(root)
    monkeypatch.setenv("HOME", str(root))
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
    sleeps, progress = [], []
    monkeypatch.setattr(hub.time, "sleep", sleeps.append)

    def rel(x):
        return str(x).replace(str(root), "<root>")

    try:
        got = ("returned", rel(call(hub, root, progress.append)))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        cause = e.__cause__
        got = ("raised", type(e).__name__, rel(e),
               (type(cause).__name__, rel(cause)) if cause else None)
    files = sorted(rel(p) for p in root.rglob("*"))
    calls = [{k: rel(v) if k == "local_dir" else v for k, v in c.items()} for c in fake.calls]
    return got, files, calls, sleeps, progress


def twin(monkeypatch, tmp_path, setup, call, fail=0, files=("model.safetensors", "config.json")):
    """Both packages' outcomes, asserted equal; returns the port's."""
    res = {name: outcome(hub, monkeypatch, tmp_path / name, setup, call, FakeHub(fail, files))
           for name, hub in HUBS.items()}
    assert res["port"] == res["jax"]
    return res["port"]


def nothing(root):
    pass


def snapshot(*names, marker=True, under="cache"):
    """A setup writing ``names`` (and the marker) into ``<root>/<under>/org/Model-1``."""
    def setup(root):
        d = root / under / "org" / "Model-1"
        d.mkdir(parents=True)
        for name in names:
            (d / name).write_text("{}")
        if marker:
            (d / ".snapshot_complete").touch()
    return setup


def test_module_constants_match():
    for name in ("DEFAULT_WEIGHT_PATTERNS", "_RETRY_DELAYS", "_COMPLETE_MARKER"):
        assert getattr(p_hub, name) == getattr(j_hub, name), name
    assert p_hub._RETRY_DELAYS == (0.0, 5.0, 15.0)


@pytest.mark.parametrize("model_id", ["org/model", "../../etc", "../evil/../../model", "a/b/c",
                                      "we!rd name/x y", ".hidden/.model", "/abs/path", "solo"])
def test_cache_key_sanitization_matches(model_id):
    """The JAX cases of ``tests/test_foundation.py`` (cache keys), and more."""
    got = p_hub.sanitized_cache_key(model_id)
    assert got == j_hub.sanitized_cache_key(model_id)
    assert ".." not in got and not got.startswith("/")
    with pytest.raises(ValueError, match="unusable model id"):
        p_hub.sanitized_cache_key("../..")
    with pytest.raises(ValueError, match="unusable model id"):
        j_hub.sanitized_cache_key("../..")


@pytest.mark.parametrize("name", ["../../../etc/passwd", "/etc/passwd", "\\evil", "a/../../b",
                                  "model.safetensors", "sub/dir/file.json", "a/./b.json"])
def test_remote_name_validation_matches(name):
    def run(hub):
        try:
            return ("ok", hub.validated_remote_file_name(name))
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(p_hub) == run(j_hub)


def test_partial_snapshot_not_treated_as_cached(tmp_path):
    """``tests/test_foundation.py``'s case in both packages: a lone
    config.json is no snapshot; pre-staged weights or the marker are."""
    snap = tmp_path / "m"
    snap.mkdir()
    (snap / "config.json").write_text("{}")
    pats = ("*.safetensors", "*.json")

    def both():
        got = p_hub._have_local_snapshot(snap, pats)
        assert got == j_hub._have_local_snapshot(snap, pats)
        return got

    assert not both()
    (snap / "model.safetensors").write_bytes(b"x")
    assert both()
    (snap / "model.safetensors").unlink()
    (snap / p_hub._COMPLETE_MARKER).touch()
    assert both()
    assert not p_hub._have_local_snapshot(tmp_path / "missing", pats)


@pytest.mark.parametrize("where", ["cache_dir", "env", "home", "cache_dir_over_env"])
def test_cache_directory_matches(where, tmp_path, monkeypatch):
    def call(hub, root, progress):
        if where in ("env", "cache_dir_over_env"):
            monkeypatch.setenv("QWEN3_CACHE_DIR", str(root / "env"))
        cache = str(root / "arg") if where in ("cache_dir", "cache_dir_over_env") else None
        return hub.get_cache_directory("../org/Model-1", cache)

    got = twin(monkeypatch, tmp_path, nothing, call)
    want = {"cache_dir": "<root>/arg", "cache_dir_over_env": "<root>/arg", "env": "<root>/env",
            "home": "<root>/.cache/qwen3-speech/models"}[where]
    assert got[0] == ("returned", want + "/org/Model-1")


def test_local_directory_passes_through(tmp_path, monkeypatch):
    """``tests/test_snapshot_layouts.py``'s local-directory case."""
    got = twin(monkeypatch, tmp_path, lambda root: (root / "ckpt").mkdir(),
               lambda hub, root, progress: hub.download_weights(
                   str(root / "ckpt"), offline_mode=True, progress_handler=progress))
    assert got[0] == ("returned", "<root>/ckpt") and got[4] == []


@pytest.mark.parametrize("how", ["offline_mode", "HF_HUB_OFFLINE"])
@pytest.mark.parametrize("cached", ["marker", "weights", "metadata", "none"])
def test_offline(how, cached, tmp_path, monkeypatch):
    """Offline (by argument or by ``HF_HUB_OFFLINE=1``) a snapshot is used
    with or without the marker, but only with a weight-bearing file;
    anything else raises ``FileNotFoundError`` (``tests/test_snapshot_layouts.py``'s
    offline case) and never fetches."""
    setup = {"marker": snapshot("config.json"),
             "weights": snapshot("model.safetensors", marker=False),
             "metadata": snapshot("config.json", marker=False),
             "none": nothing}[cached]

    def call(hub, root, progress):
        if how == "HF_HUB_OFFLINE":
            monkeypatch.setenv("HF_HUB_OFFLINE", "1")
        return hub.download_weights(MODEL, cache_dir=str(root / "cache"),
                                    offline_mode=how == "offline_mode",
                                    progress_handler=progress)

    got = twin(monkeypatch, tmp_path, setup, call)
    if cached in ("marker", "weights"):
        assert got[0] == ("returned", "<root>/cache/org/Model-1")
    else:
        assert got[0] == ("raised", "FileNotFoundError", "offline mode: no cached snapshot for "
                          "org/Model-1 at <root>/cache/org/Model-1", None)
    assert got[2] == [] and got[4] == []


def test_cached_snapshot_reports_progress(tmp_path, monkeypatch):
    got = twin(monkeypatch, tmp_path, snapshot("model.safetensors"),
               lambda hub, root, progress: hub.download_weights(
                   MODEL, cache_dir=str(root / "cache"), progress_handler=progress))
    assert got[0] == ("returned", "<root>/cache/org/Model-1")
    assert got[2] == [] and got[4] == [1.0]


@pytest.mark.parametrize("where", ["cache_dir", "env", "home"])
def test_fetch_writes_files_and_marker(where, tmp_path, monkeypatch):
    """No snapshot: one fetch into the cache with the patterns, the
    additional files and patterns, then the marker and progress 1.0."""
    def call(hub, root, progress):
        if where == "env":
            monkeypatch.setenv("QWEN3_CACHE_DIR", str(root / "env"))
        return hub.download_weights(
            MODEL, cache_dir=str(root / "arg") if where == "cache_dir" else None,
            additional_files=("vocab.json", "sub/merges.txt"), additional_patterns=["voices/*"],
            progress_handler=progress)

    got = twin(monkeypatch, tmp_path, nothing, call)
    base = {"cache_dir": "<root>/arg", "env": "<root>/env",
            "home": "<root>/.cache/qwen3-speech/models"}[where] + "/org/Model-1"
    assert got[0] == ("returned", base)
    assert {base + "/.snapshot_complete", base + "/model.safetensors"} <= set(got[1])
    assert got[2] == [{"repo_id": MODEL, "local_dir": base,
                       "allow_patterns": list(p_hub.DEFAULT_WEIGHT_PATTERNS)
                       + ["voices/*", "vocab.json", "sub/merges.txt"]}]
    assert got[3] == [] and got[4] == [1.0]


def test_a_metadata_only_cache_is_fetched_again(tmp_path, monkeypatch):
    got = twin(monkeypatch, tmp_path, snapshot("config.json", marker=False),
               lambda hub, root, progress: hub.download_weights(
                   MODEL, cache_dir=str(root / "cache"), patterns=("*.nemo", "*.json")))
    assert got[0] == ("returned", "<root>/cache/org/Model-1")
    assert [c["allow_patterns"] for c in got[2]] == [["*.nemo", "*.json"]]


def test_two_failures_then_success(tmp_path, monkeypatch):
    got = twin(monkeypatch, tmp_path, nothing,
               lambda hub, root, progress: hub.download_weights(
                   MODEL, cache_dir=str(root / "cache"), progress_handler=progress), fail=2)
    assert got[0] == ("returned", "<root>/cache/org/Model-1")
    assert len(got[2]) == 3 and got[3] == [5.0, 15.0] and got[4] == [1.0]
    assert "<root>/cache/org/Model-1/.snapshot_complete" in got[1]


def test_three_failures_raise_with_the_cause(tmp_path, monkeypatch):
    got = twin(monkeypatch, tmp_path, nothing,
               lambda hub, root, progress: hub.download_weights(
                   MODEL, cache_dir=str(root / "cache"), progress_handler=progress), fail=3)
    assert got[0] == ("raised", "RuntimeError", "failed to download org/Model-1 after 3 attempts",
                      ("ConnectionError", "attempt 3: no route to host"))
    assert len(got[2]) == 3 and got[3] == [5.0, 15.0] and got[4] == []
    assert "<root>/cache/org/Model-1/.snapshot_complete" not in got[1]


@pytest.mark.parametrize("bad", ["../../escape.json", "/etc/passwd"])
def test_traversing_additional_file_is_refused_before_anything(bad, tmp_path, monkeypatch):
    got = twin(monkeypatch, tmp_path, nothing,
               lambda hub, root, progress: hub.download_weights(
                   MODEL, cache_dir=str(root / "cache"), additional_files=("ok.json", bad)))
    assert got[0][:2] == ("raised", "ValueError") and got[2] == [] and got[1] == []


# ---------------------------------------------------------------------------
# every from_pretrained hands download_weights the reference's arguments
# ---------------------------------------------------------------------------

FAMILIES = [
    ("diarization.sortformer", "SortformerDiarizer"), ("translation.model", "MADLADTranslator"),
    ("silero_vad.model", "SileroVAD"), ("firered_vad.model", "FireRedVAD"),
    ("chat.model", "Qwen3Chat"), ("enhancement.model", "SpeechEnhancer"),
    ("parakeet.model", "ParakeetASR"), ("parakeet_streaming.model", "ParakeetStreamingASR"),
    ("speaker.model", "WeSpeaker"), ("speaker.campplus", "CampPlusSpeaker"),
    ("separation.model", "SourceSeparator"), ("cosyvoice.model", "CosyVoiceTTS"),
    ("qwen3_tts.model", "Qwen3TTS"), ("personaplex.model", "PersonaPlex"),
    ("omnilingual.model", "OmnilingualASR"), ("voxcpm2.model", "VoxCPM2TTS"),
    ("vibevoice.model", "VibeVoiceTTS"), ("kokoro.model", "KokoroTTS"),
    ("wakeword.model", "WakeWordDetector"), ("pyannote.model", "PyannoteSegmentation"),
    ("qwen3_asr.model", "Qwen3ASR"), ("qwen3_asr.aligner", "Qwen3ForcedAligner"),
]


class Sentinel(Exception):
    pass


def recorded_call(pkg, module, cls_name, monkeypatch, **kw):
    """The arguments ``cls.from_pretrained(**kw)`` hands ``download_weights``
    (which raises :class:`Sentinel` in place of loading)."""
    hub = importlib.import_module(f"{pkg}.core.hub")
    seen = []

    def recorder(*args, **kwargs):
        seen.append((args, kwargs))
        raise Sentinel

    monkeypatch.setattr(hub, "download_weights", recorder)
    cls = getattr(importlib.import_module(f"{pkg}.models.{module}"), cls_name)
    with pytest.raises(Sentinel):
        cls.from_pretrained(**kw)
    (args, kwargs), = seen
    if kwargs.get("progress_handler") is not None:
        kwargs["progress_handler"] = "present"
    return args, kwargs


def test_every_family_is_listed():
    """The 22 ``from_pretrained`` that call ``download_weights``, in both
    packages' sources."""
    for pkg in ("qwen3_asr_swift_tpu", "qwen3_asr_swift_tpu_torch"):
        root = Path(importlib.import_module(pkg).__file__).parent / "models"
        calls = sorted(".".join(p.relative_to(root).with_suffix("").parts)
                       for p in root.rglob("*.py") if "download_weights(" in p.read_text())
        assert calls == sorted(m for m, _ in FAMILIES), pkg


@pytest.mark.parametrize("module,cls_name", FAMILIES)
@pytest.mark.parametrize("args", ["defaults", "cache_offline_progress"])
def test_from_pretrained_passes_the_references_arguments(module, cls_name, args, monkeypatch):
    kw = {}
    if args != "defaults":
        kw = {"cache_dir": "/models/cache", "offline_mode": True,
              "progress_handler": lambda *a: None}
    got = recorded_call("qwen3_asr_swift_tpu_torch", module, cls_name, monkeypatch,
                        device="cpu", **kw)
    want = recorded_call("qwen3_asr_swift_tpu", module, cls_name, monkeypatch, **kw)
    assert got == want


# ---------------------------------------------------------------------------
# end to end: a cached snapshot loaded by id, offline
# ---------------------------------------------------------------------------

CFG = config_tiny()


def write_checkpoint(d: Path):
    enc, dec = init_random_params(CFG, seed=0, quant_bits=4)
    save_checkpoint(checkpoint_flat(enc, dec), d)
    b2u = _bytes_to_unicode()
    (d / "vocab.json").write_text(json.dumps({b2u[b]: b for b in range(256)}))
    (d / "merges.txt").write_text("#version: 0.2\n")


@pytest.mark.parametrize("how", ["offline_mode", "HF_HUB_OFFLINE", "QWEN3_CACHE_DIR"])
def test_cached_id_loads_the_tokens_of_the_directory(how, tmp_path, monkeypatch):
    """A packed checkpoint (group 64) written into the cache under an id,
    with the marker, loaded by that id offline: the same greedy tokens as
    the checkpoint loaded by its directory, and the reference's progress
    calls."""
    assert CFG.decoder.group_size == 64
    model_id = "tiny-org/Qwen3-ASR-tiny-4bit"
    cache = tmp_path / "cache"
    snap = cache / "tiny-org" / "Qwen3-ASR-tiny-4bit"
    snap.mkdir(parents=True)
    write_checkpoint(snap)
    (snap / ".snapshot_complete").touch()
    monkeypatch.setattr(p_model, "detect_config", lambda model_id: CFG)
    kw = dict(dtype=torch.float32, audio_buckets_s=(8,), device="cpu")
    progress = []
    if how == "offline_mode":
        by_id = Qwen3ASR.from_pretrained(model_id, cache_dir=str(cache), offline_mode=True,
                                         progress_handler=lambda *a: progress.append(a), **kw)
    else:
        monkeypatch.setenv("QWEN3_CACHE_DIR", str(cache))
        if how == "HF_HUB_OFFLINE":
            monkeypatch.setenv("HF_HUB_OFFLINE", "1")
        else:  # online: the cached snapshot is used without a fetch
            monkeypatch.setitem(sys.modules, "huggingface_hub", None)
        by_id = Qwen3ASR.from_pretrained(model_id, progress_handler=lambda *a: progress.append(a),
                                         **kw)
    by_dir = Qwen3ASR.from_pretrained(str(snap), **kw)
    rng = np.random.default_rng(4)
    clips = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 40000)]
    got = [r.text for r in by_id.transcribe_batch(clips, max_tokens=8)]
    want = [r.text for r in by_dir.transcribe_batch(clips, max_tokens=8)]
    assert got == want and by_id.tokenizer is not None
    cached = [] if how != "QWEN3_CACHE_DIR" else [(0.8, "Downloading weights...")]
    assert progress == ([(0.0, "Downloading model...")] + cached
                        + [(0.8, "Loading tokenizer..."), (0.85, "Converting weights..."),
                           (1.0, "Ready")])
