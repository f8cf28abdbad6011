"""Checkpoints: the port's loader and converter against the JAX package's.

The test writes its own checkpoint in the published layout (``audio_tower.*``
and ``model.*``, torch OIHW convs, MLX-packed 4-bit decoder linears and
embedding) at the group-64 tiny config, with fp32, fp16 and bf16 tensors.

- ``load_safetensors`` reads bf16 without ``ml_dtypes``: float32 arrays
  holding the same values as the reference's bf16 arrays;
- ``convert_encoder`` and ``convert_decoder`` give trees equal to the
  reference's, leaf for leaf, dtypes included (exact);
- ``Qwen3ASR.from_pretrained(dir)`` against the reference's, with
  ``detect_config`` patched to the tiny config in both packages: identical
  greedy tokens dequantized; packed (bf16 activations in both), identical
  up to a near-tie, which the test shows is one;
- a model id that is neither a directory nor a cached snapshot raises offline.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_asr_swift_tpu.models.qwen3_asr.model as j_model
from qwen3_asr_swift_tpu.core import weights as j_weights
from qwen3_asr_swift_tpu.models.qwen3_asr import Qwen3ASR as JaxQwen3ASR
from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jax_tiny
from qwen3_asr_swift_tpu.models.qwen3_asr import convert as j_convert
from qwen3_asr_swift_tpu.ops.sampling import SamplingOptions as JaxOptions
from qwen3_asr_swift_tpu_torch.core import weights as p_weights
from qwen3_asr_swift_tpu_torch.core.params import (checkpoint_flat, init_random_params,
                                                    round_floats, save_checkpoint)
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import Qwen3ASR, config_tiny
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import convert as p_convert
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import model as p_model
from qwen3_asr_swift_tpu_torch.ops.sampling import SamplingOptions
from qwen3_asr_swift_tpu_torch.tokenizers.bpe import _bytes_to_unicode


def shrink(cfg):
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                         num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))


CFG, JCFG = shrink(config_tiny()), shrink(jax_tiny())


def storage_dtype(name: str):
    """fp16 encoder layers, bf16 decoder group scales/biases and norms,
    fp32 for the rest."""
    if name.startswith("audio_tower.layers."):
        return torch.float16
    if name.startswith("model.") and name.endswith((".scales", ".biases", "norm.weight")):
        return torch.bfloat16
    return torch.float32


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    enc, dec = init_random_params(CFG, seed=0, quant_bits=4)
    flat = checkpoint_flat(enc, dec)
    d = tmp_path_factory.mktemp("ckpt") / "Qwen3-ASR-tiny-4bit"
    save_checkpoint(flat, d, dtype_of=storage_dtype)
    enc_bytes = _bytes_to_unicode()
    (d / "vocab.json").write_text(json.dumps({enc_bytes[b]: b for b in range(256)}))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return d, flat


def test_load_safetensors_reads_bf16_without_ml_dtypes(checkpoint):
    d, flat = checkpoint
    got, want = p_weights.load_safetensors(d), j_weights.load_safetensors(d)
    assert sorted(got) == sorted(want) == sorted(flat)
    assert {w.dtype.name for w in want.values()} == {"float16", "bfloat16", "float32", "uint32"}
    for name, w in want.items():
        g = got[name]
        if w.dtype.name == "bfloat16":
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w.astype(np.float32))
            # the stored value is the fp32 one rounded to bf16
            np.testing.assert_array_equal(g, round_floats(flat[name]))
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    as32 = p_weights.load_safetensors(d, dtype=np.float32)
    assert all(a.dtype == np.float32 for n, a in as32.items() if n.endswith(".scales"))


def _assert_trees_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("keep_quantized", [True, False])
def test_converted_trees_equal_the_reference(checkpoint, keep_quantized):
    d, _ = checkpoint
    got_flat, want_flat = p_weights.load_safetensors(d), j_weights.load_safetensors(d)
    for fn in ("convert_encoder", "convert_decoder"):
        got = getattr(p_convert, fn)(got_flat, CFG, keep_quantized=keep_quantized)
        want = getattr(j_convert, fn)(want_flat, JCFG, keep_quantized=keep_quantized)
        _assert_trees_equal(got, want, fn)


def test_thinker_prefix_is_stripped():
    flat = {"thinker.model.norm.weight": np.ones(3, np.float32), "model.x": np.zeros(1)}
    assert sorted(p_convert.strip_prefixes(flat)) == sorted(j_convert.strip_prefixes(flat))


def greedy_tokens(model, cls, opts, clips):
    """The token buffer and n_gen each transcribe hands to ``_finalize``."""
    seen = []

    def finalize(tokens, n_gen, *rest):
        seen.append((np.array(tokens), np.array(n_gen)))
        return cls._finalize(model, tokens, n_gen, *rest)

    model._finalize = finalize
    model.transcribe_batch(clips, options=opts(max_tokens=8))
    return seen[0]


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(4)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 30000)]


def test_from_pretrained_matches_the_reference(checkpoint, clips, monkeypatch):
    """Dequantized fp32 decoders, so both packages compute one fp32
    function and the greedy tokens must be identical. (A packed decoder's
    activations are bf16 in both packages; on this checkpoint's nearly flat
    logits a bf16 rounding that lands the other way flips a near-tie, which
    ``tests/test_torch_slice.py`` bounds instead.)"""
    d, _ = checkpoint
    monkeypatch.setattr(j_model, "detect_config", lambda model_id: JCFG)
    monkeypatch.setattr(p_model, "detect_config", lambda model_id: CFG)
    jm = JaxQwen3ASR.from_pretrained(str(d), dtype=jnp.float32, audio_buckets_s=(8,),
                                     quant_compute="dequant")
    pm = Qwen3ASR.from_pretrained(str(d), device="cpu", dtype=torch.float32,
                                  audio_buckets_s=(8,), quant_compute="dequant")
    assert pm.tokenizer is not None and pm.tokenizer.vocab_size == 256
    got = greedy_tokens(pm, Qwen3ASR, SamplingOptions, clips)
    want = greedy_tokens(jm, JaxQwen3ASR, JaxOptions, clips)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_loaded_packed_model_matches_the_in_memory_one(checkpoint, clips, monkeypatch):
    """The packed decoder as loaded equals the port's model built in
    memory from the same arrays: identical tokens."""
    d, _ = checkpoint
    monkeypatch.setattr(p_model, "detect_config", lambda model_id: CFG)
    loaded = Qwen3ASR.from_pretrained(str(d), device="cpu", dtype=torch.float32,
                                      audio_buckets_s=(8,), kv_dtype=torch.int8)
    flat = p_weights.load_safetensors(d)
    built = Qwen3ASR(CFG, p_convert.convert_encoder(flat, CFG), p_convert.convert_decoder(flat, CFG),
                     device="cpu", dtype=torch.float32, audio_buckets_s=(8,), kv_dtype=torch.int8)
    for g, w in zip(greedy_tokens(loaded, Qwen3ASR, SamplingOptions, clips),
                    greedy_tokens(built, Qwen3ASR, SamplingOptions, clips)):
        np.testing.assert_array_equal(g, w)


def step_logits(module, jax_side):
    """Patch ``module.sample_token`` to record each step's logits:
    ``{step: [B, vocab] float32}``."""
    seen = {}
    real = module.sample_token
    if jax_side:
        import jax

        def sample(logits, key, opts, tokens, step):
            jax.debug.callback(lambda a, s: seen.__setitem__(int(np.asarray(s)[0]), np.array(a)),
                               logits, step)
            return real(logits, key, opts, tokens, step)
    else:
        def sample(logits, opts, generator, tokens, step, **kw):
            seen[int(step)] = logits.float().numpy().copy()
            return real(logits, opts, generator, tokens, step, **kw)
    return seen, sample


def test_loaded_packed_model_matches_the_reference_up_to_a_near_tie(checkpoint, clips,
                                                                    monkeypatch):
    """The packed path as loaded, against the reference's on the same
    checkpoint. Its activations are bf16 in both packages (the packed
    embedding's rows), so the logits differ by bf16 roundings (relative L2
    at most 2e-2, as ``tests/test_torch_qwen3_asr.py`` holds a packed
    decode step) and a greedy token may part at a near-tie. Each row's
    tokens equal the reference's up to the first step where they part; at
    that step the reference's margin between its token and the port's is
    within twice the largest logit gap of the step, the most a pair of
    logits can move against each other."""
    d, _ = checkpoint
    monkeypatch.setattr(j_model, "detect_config", lambda model_id: JCFG)
    monkeypatch.setattr(p_model, "detect_config", lambda model_id: CFG)
    jm = JaxQwen3ASR.from_pretrained(str(d), dtype=jnp.float32, audio_buckets_s=(8,))
    pm = Qwen3ASR.from_pretrained(str(d), device="cpu", dtype=torch.float32,
                                  audio_buckets_s=(8,))
    want_logits, sample = step_logits(j_model, jax_side=True)
    monkeypatch.setattr(j_model, "sample_token", sample)
    want, want_n = greedy_tokens(jm, JaxQwen3ASR, JaxOptions, clips)
    got_logits, sample = step_logits(p_model, jax_side=False)
    monkeypatch.setattr(p_model, "sample_token", sample)
    got, got_n = greedy_tokens(pm, Qwen3ASR, SamplingOptions, clips)
    for b in range(len(clips)):
        n = min(got_n[b], want_n[b])
        parted = [s for s in range(n) if got[b, s] != want[b, s]]
        last = parted[0] if parted else n - 1
        if not parted:
            assert got_n[b] == want_n[b]
        for s in range(last + 1):
            g, w = got_logits[s][b], want_logits[s][b]
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 2e-2, (b, s)
        if parted:
            s = parted[0]
            g, w = got_logits[s][b], want_logits[s][b]
            margin = w[want[b, s]] - w[got[b, s]]
            gap = np.abs(g - w).max()
            print(f"row {b} parts at step {s}: reference margin {margin:.6g}, "
                  f"largest logit gap {gap:.6g}")
            assert 0 <= margin <= 2 * gap


def test_from_pretrained_without_tokenizer_files_and_round_trip(tmp_path, monkeypatch):
    """``save_checkpoint`` writes what ``from_pretrained`` reads back: the
    same tree (floats stored as bf16), no tokenizer files → ids as text."""
    monkeypatch.setattr(p_model, "detect_config", lambda model_id: CFG)
    enc, dec = round_floats(init_random_params(CFG, seed=1, quant_bits=4))
    save_checkpoint(checkpoint_flat(enc, dec), tmp_path)
    flat = p_weights.load_safetensors(tmp_path)
    _assert_trees_equal(p_convert.convert_decoder(flat, CFG),
                        j_convert.convert_decoder(checkpoint_flat(enc, dec), JCFG))
    pm = Qwen3ASR.from_pretrained(str(tmp_path), device="cpu", dtype=torch.float32,
                                  audio_buckets_s=(8,))
    assert pm.tokenizer is None
    res = pm.transcribe(np.zeros(8000, np.float32), max_tokens=3)
    assert all(t.isdigit() for t in res.text.split())


def test_model_id_that_is_not_a_directory_raises(tmp_path):
    """An id that is neither a directory nor a snapshot in the cache raises
    the reference's ``FileNotFoundError`` offline (no fetch is tried)."""
    cache = str(tmp_path / "cache")
    with pytest.raises(FileNotFoundError, match="offline mode: no cached snapshot"):
        Qwen3ASR.from_pretrained(str(tmp_path / "missing"), device="cpu", cache_dir=cache,
                                 offline_mode=True)
    with pytest.raises(FileNotFoundError, match="offline mode: no cached snapshot for "
                                                "aufklarer/Qwen3-ASR-0.6B-MLX-4bit"):
        Qwen3ASR.from_pretrained("aufklarer/Qwen3-ASR-0.6B-MLX-4bit", device="cpu",
                                 cache_dir=cache, offline_mode=True)


@pytest.mark.parametrize("model_id", ["aufklarer/Qwen3-ASR-0.6B-MLX-4bit", "x/Qwen3-ASR-1.7B-8bit",
                                      "local/qwen3-asr-1.7b", "Qwen3-ASR-0.6B-bf16", "plain"])
def test_detect_config_matches(model_id):
    from qwen3_asr_swift_tpu.models.qwen3_asr import detect_config as j_detect
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import detect_config as p_detect

    got, want = p_detect(model_id), j_detect(model_id)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
