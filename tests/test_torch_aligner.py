"""The port's forced aligner against the JAX package's.

- the host functions (``split_word_pairs``, ``slot_text``,
  ``lis_positions``, ``enforce_monotonicity``) are copies: equal source and
  equal results;
- ``_raw_indices``, ``align`` and ``align_long`` give the same slot
  classes, words and times as the JAX aligner on the same weights, at fp32
  with a dense decoder (one fp32 function in both packages, so an argmax
  cannot move on a rounding); ``align_long`` runs with a ``max_chunk_s`` of
  a few seconds on both sides, so it takes several chunks;
- with a packed decoder, a prompt of at most 256 rows sends the prefill's
  products to kernel K1's wrapper and a longer one to the plain product.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.qwen3_asr import aligner as j_al
from qwen3_asr_swift_tpu.models.qwen3_asr import config_tiny as jax_tiny
from qwen3_asr_swift_tpu.tokenizers.bpe import BPETokenizer as JaxBPE
from qwen3_asr_swift_tpu_torch.core.params import init_random_params
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import aligner as p_al
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import config_tiny
from qwen3_asr_swift_tpu_torch.ops import quant as pq
from qwen3_asr_swift_tpu_torch.tokenizers.bpe import BPETokenizer, _bytes_to_unicode

HOST = ["split_word_pairs", "slot_text", "lis_positions", "enforce_monotonicity"]
TEXT = "Hello, world! This is a test of the forced aligner -- twenty words or so, said slowly."


def shrink(cfg):
    return dataclasses.replace(
        cfg, classify_num=100,
        decoder=dataclasses.replace(cfg.decoder, hidden_size=128, intermediate_size=256,
                                    num_heads=4, num_kv_heads=2, head_dim=32),
        encoder=dataclasses.replace(cfg.encoder, output_dim=128))


CFG, JCFG = shrink(config_tiny()), shrink(jax_tiny())


def byte_vocab():
    enc = _bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256)}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("t", "h"), ("Ġ", "t")]
    for i, (a, b) in enumerate(merges):
        vocab[a + b] = 256 + i
    return vocab, merges


@pytest.fixture(scope="module")
def tokenizers():
    vocab, merges = byte_vocab()
    return BPETokenizer(vocab, merges), JaxBPE(vocab, merges)


@pytest.fixture(scope="module")
def aligners(tokenizers):
    enc, dec = init_random_params(CFG, seed=0)
    head = {"kernel": np.random.default_rng(1).standard_normal(
        (CFG.decoder.hidden_size, CFG.classify_num)).astype(np.float32)}
    pt, jt = tokenizers
    port = p_al.Qwen3ForcedAligner(CFG, enc, dec, head, pt, device="cpu", dtype=torch.float32,
                                   max_chunk_s=3.0)
    ref = j_al.Qwen3ForcedAligner(JCFG, enc, dec, head, jt, dtype=jnp.float32, max_chunk_s=3.0)
    return port, ref


@pytest.fixture(scope="module")
def clip():
    return (0.1 * np.random.default_rng(2).standard_normal(int(2.5 * 16000))).astype(np.float32)


def test_host_functions_are_copies():
    for name in HOST + ["SlottedText"]:
        got, want = inspect.getsource(getattr(p_al, name)), inspect.getsource(getattr(j_al, name))
        assert got == want, name


@pytest.mark.parametrize("text,lang", [(TEXT, "English"), ("  ...  ", "English"),
                                       ("你好，世界。今天天气很好！", "Chinese"),
                                       ("日本語のテキスト、です。", "ja")])
def test_split_and_slot_match(tokenizers, text, lang):
    pt, jt = tokenizers
    assert p_al.split_word_pairs(text, lang) == j_al.split_word_pairs(text, lang)
    got, want = p_al.slot_text(text, pt, 509, lang), j_al.slot_text(text, jt, 509, lang)
    assert (got.token_ids, got.timestamp_positions, got.words) == \
        (want.token_ids, want.timestamp_positions, want.words)


@pytest.mark.parametrize("seed", range(6))
def test_monotonicity_matches(seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 60, int(rng.integers(0, 30))).tolist()
    if seed == 5:
        raw = sorted(raw)
    assert p_al.lis_positions(raw) == j_al.lis_positions(raw)
    assert p_al.enforce_monotonicity(raw) == j_al.enforce_monotonicity(raw)


def test_raw_indices_match(aligners, clip):
    port, ref = aligners
    slotted = p_al.slot_text(TEXT, port.tokenizer, CFG.timestamp_id)
    jslotted = j_al.slot_text(TEXT, ref.tokenizer, JCFG.timestamp_id)
    got = port._raw_indices(clip, slotted)
    assert len(got) == 2 * len(slotted.words)
    assert got == ref._raw_indices(clip, jslotted)


def _words(ws):
    return [(w.word, round(w.start, 6), round(w.end, 6), w.confidence) for w in ws]


def test_align_matches(aligners, clip):
    port, ref = aligners
    got = port.align(clip, TEXT)
    n_words = len(p_al.slot_text(TEXT, port.tokenizer, CFG.timestamp_id).words)
    assert len(got) == n_words == 16 and _words(got) == _words(ref.align(clip, TEXT))
    starts = [w.start for w in got]
    assert starts == sorted(starts) and all(w.end >= w.start for w in got)
    assert port.align(clip, "  ...  ") == [] == list(ref.align(clip, "  ...  "))


def test_align_long_matches(aligners):
    """7 s against chunks of 3 s: the plateau rule and the resumption run
    on both sides."""
    port, ref = aligners
    audio = (0.1 * np.random.default_rng(3).standard_normal(7 * 16000)).astype(np.float32)
    got = port.align(audio, TEXT)
    assert got and _words(got) == _words(ref.align(audio, TEXT))
    assert _words(port.align_long(audio, TEXT)) == _words(ref.align_long(audio, TEXT))
    with pytest.raises(RuntimeError, match="requires a tokenizer"):
        p_al.Qwen3ForcedAligner(CFG, *init_random_params(CFG, 0), {"kernel": np.zeros(
            (128, 100), np.float32)}, device="cpu").align(audio, TEXT)


@pytest.mark.parametrize("seconds,words,kernel_rows", [(3, 4, True), (3, 40, False), (6, 4, False)])
def test_packed_prefill_takes_k1_up_to_256_rows(tokenizers, clip, seconds, words, kernel_rows,
                                                 monkeypatch):
    """At the published encoder window (800 mel frames) the smallest audio
    bucket is 8 s, 104 rows, so with the 32-row prefix block and a text
    block of at least 128 rows every aligner prompt has 264 rows or more
    and takes the plain product. An encoder window of 400 frames allows a
    4 s bucket (52 rows): a short text then fits 212 rows, and every packed
    product of the prefill goes to K1's wrapper."""
    cfg = dataclasses.replace(CFG, encoder=dataclasses.replace(CFG.encoder, n_window_infer=400))
    al = p_al.Qwen3ForcedAligner.init_random(cfg, 0, device="cpu", dtype=torch.float32,
                                             tokenizer=tokenizers[0], quant_bits=4)
    al._asr._audio_buckets_s = (4, 8)
    calls = []
    real = pq.quant_matmul_cuda
    monkeypatch.setattr(pq, "quant_matmul_cuda", lambda x, p: calls.append(x.shape) or real(x, p))
    audio = (0.1 * np.random.default_rng(4).standard_normal(seconds * 16000)).astype(np.float32)
    out = al.align(audio, " ".join(["word"] * words))
    assert len(out) == words
    text_rows = words * (len("word") + 2) + 6   # byte tokens and two slots a word
    rows = 32 + (52 if seconds <= 4 else 104) + (128 if text_rows <= 128 else 256)
    assert (len(calls) > 0) == kernel_rows == (rows <= pq.KERNEL_MAX_ROWS)
    if kernel_rows:   # q, o, gate_up and down of every layer (k/v stay dense at this width)
        assert len(calls) == 4 * cfg.decoder.num_layers
        assert all(s[:-1] == (1, rows) for s in calls)


def test_from_pretrained_matches_the_reference(tokenizers, clip, tmp_path, monkeypatch):
    """A checkpoint in the aligner's published layout (``thinker.`` prefix,
    a 4-bit ``lm_head`` as the classify head, bf16 floats) loads in both
    packages to the same words and times."""
    import json

    from qwen3_asr_swift_tpu.models.qwen3_asr import config as j_config
    from qwen3_asr_swift_tpu_torch.core.params import checkpoint_flat, save_checkpoint
    from qwen3_asr_swift_tpu_torch.core.weights import quantize_mlx
    from qwen3_asr_swift_tpu_torch.models.qwen3_asr import config as p_config

    enc, dec = init_random_params(CFG, seed=3)
    head = np.random.default_rng(4).standard_normal((CFG.classify_num, 128)).astype(np.float32)
    flat = {f"thinker.{k}": v for k, v in checkpoint_flat(enc, dec).items()}
    for name, arr in zip(("weight", "scales", "biases"), quantize_mlx(head, 4, 64)):
        flat[f"thinker.lm_head.{name}"] = arr
    save_checkpoint(flat, tmp_path)
    vocab, merges = byte_vocab()
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("\n".join(" ".join(m) for m in merges))
    for cfg_mod, al_mod, cfg in ((p_config, p_al, CFG), (j_config, j_al, JCFG)):
        monkeypatch.setattr(cfg_mod, "detect_config", lambda model_id, _c=cfg: _c)
        monkeypatch.setattr(al_mod, "ENCODER_ALIGNER", cfg.encoder)
    port = p_al.Qwen3ForcedAligner.from_pretrained(str(tmp_path), device="cpu",
                                                   dtype=torch.float32)
    ref = j_al.Qwen3ForcedAligner.from_pretrained(str(tmp_path), dtype=jnp.float32)
    assert port.classify_params["kernel"].shape == (128, CFG.classify_num)
    got = port.align(clip, TEXT)
    assert got and _words(got) == _words(ref.align(clip, TEXT))
