"""The Sortformer diarizer (``qwen3_asr_swift_tpu_torch/models/diarization/
sortformer.py``) against its JAX twin on the CPU.

One numpy-drawn tree at ``config_tiny()`` (every leaf jittered) goes to
both packages. ``sortformer_chunk``'s predictions and embeddings within
1e-5 of max |reference| (fp32 both), with a part-filled speaker cache and
FIFO; ``diarize`` over a clip of 13 chunks: the speaker cache and the FIFO
after every chunk within 1e-5 and their lengths equal, the segments
equal. The host's streaming update is a copy (held in
``test_torch_vendored.py``); here it runs on chunks larger than the FIFO.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models.diarization import sortformer as j_sf
from qwen3_asr_swift_tpu_torch.models.diarization import sortformer as p_sf

TOL = 1e-5
CFG = p_sf.config_tiny()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The chunk loop is a chain of small ops: with several test workers on
    the host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jitter(tree, rng, scale=0.3):
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
def pair():
    tree = jitter(p_sf.init_sortformer_params(np.random.default_rng(0), CFG),
                  np.random.default_rng(1))
    return (j_sf.SortformerDiarizer(j_sf.config_tiny(), jax.tree_util.tree_map(jnp.asarray, tree)),
            p_sf.SortformerDiarizer(CFG, tree, device="cpu"))


def voices(n, seed=10):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = np.where((t // 0.5).astype(int) % 2 == 0, 130.0, 250.0)
    wave = sum(np.sin(2 * np.pi * np.cumsum(f0) / 16000 * k) / k for k in range(1, 5))
    return (0.3 * wave * ((t % 0.5) < 0.4) + 0.02 * rng.standard_normal(n)).astype(np.float32)


def test_configs_match():
    for got, want in ((CFG, j_sf.config_tiny()), (p_sf.CONFIG_SORTFORMER, j_sf.CONFIG_SORTFORMER)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.chunk_mel == want.chunk_mel
        assert dataclasses.asdict(got.encoder_config()) == dataclasses.asdict(want.encoder_config())


@pytest.mark.parametrize("chunk_len,spk_len,fifo_len", [(32, 0, 0), (25, 7, 3), (32, 12, 4)])
def test_sortformer_chunk_matches(pair, chunk_len, spk_len, fifo_len):
    rng = np.random.default_rng(chunk_len + spk_len)
    mel = rng.standard_normal((CFG.chunk_mel, CFG.n_mels)).astype(np.float32)
    mel[chunk_len:] = 0.0
    cache = rng.standard_normal((CFG.spkcache_len, CFG.d_model)).astype(np.float32)
    fifo = rng.standard_normal((CFG.fifo_len, CFG.d_model)).astype(np.float32)
    want = j_sf.sortformer_chunk(pair[0].params, j_sf.config_tiny(), jnp.asarray(mel),
                                 jnp.asarray(chunk_len), jnp.asarray(cache), jnp.asarray(spk_len),
                                 jnp.asarray(fifo), jnp.asarray(fifo_len))
    with torch.inference_mode():
        got = p_sf.sortformer_chunk(pair[1].params, CFG, torch.from_numpy(mel), chunk_len,
                                    torch.from_numpy(cache), spk_len, torch.from_numpy(fifo),
                                    fifo_len)
    close(got[0], want[0])
    close(got[1], want[1])
    assert got[2] == int(want[2])


def states_after_each_chunk(model):
    """Wrap ``model._update_state`` to record (speaker cache, its length,
    FIFO, its length) after every chunk."""
    seen = []
    update = model._update_state

    def record(embs):
        update(embs)
        seen.append((model._spkcache.copy(), model._spk_len, model._fifo.copy(), model._fifo_len))
    model._update_state = record
    return seen


def test_diarize_matches_chunk_by_chunk(pair):
    audio = voices(16000 * 2)
    ref_states, port_states = states_after_each_chunk(pair[0]), states_after_each_chunk(pair[1])
    try:
        want, got = pair[0].diarize(audio), pair[1].diarize(audio)
    finally:
        for m in pair:
            del m._update_state
    assert len(ref_states) == len(port_states) == 13
    for (gc, gl, gf, gfl), (wc, wl, wf, wfl) in zip(port_states, ref_states):
        assert (gl, gfl) == (wl, wfl)
        close(gc, wc)
        close(gf, wf)
    assert ref_states[-1][1] == CFG.spkcache_len
    assert len(want) >= 2
    assert [(s.start, s.end, s.speaker) for s in got] == [(s.start, s.end, s.speaker) for s in want]
    assert pair[1].diarize(np.zeros(0, np.float32)) == []


def test_streaming_update_takes_chunks_larger_than_the_fifo(pair):
    """The pretrained geometry's 75-frame chunks against a 40-frame FIFO, in
    miniature: chunks of 7 rows into the tiny FIFO of 4, both packages."""
    rng = np.random.default_rng(3)
    for m in pair:
        m.reset_state()
    for _ in range(5):
        embs = rng.standard_normal((7, CFG.d_model)).astype(np.float32)
        for m in pair:
            m._update_state(embs)
        np.testing.assert_array_equal(pair[1]._spkcache, pair[0]._spkcache)
        np.testing.assert_array_equal(pair[1]._fifo, pair[0]._fifo)
        assert (pair[1]._spk_len, pair[1]._fifo_len) == (pair[0]._spk_len, pair[0]._fifo_len)
