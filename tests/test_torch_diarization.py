"""The diarization pipeline (``qwen3_asr_swift_tpu_torch/models/diarization``)
over twin Silero VADs and twin WeSpeakers, against the JAX package's on the
CPU.

The pipeline is a copy of the reference's (jax-free); what it runs over is
the port's. Both packages' Silero VADs run on the audio (the port's
probabilities within 1e-5 of the reference's), and an energy decision a
512-sample chunk is laid over them, so both pipelines see the same speech
regions. The WeSpeakers share one numpy-drawn tree at narrow widths. The
segments, speakers and DER equal the reference's; the linkage's merge
distances are checked clear of the threshold, so equal labels are the
claim and not luck.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu.models import diarization as j_diar
from qwen3_asr_swift_tpu.models.silero_vad import model as j_vad
from qwen3_asr_swift_tpu.models.speaker import model as j_wes
from qwen3_asr_swift_tpu_torch.models import diarization as p_diar
from qwen3_asr_swift_tpu_torch.models.silero_vad import model as p_vad
from qwen3_asr_swift_tpu_torch.models.speaker import model as p_wes

WES_WIDTHS = dict(embed_dim=16, channels=(4, 8, 8, 8), blocks=(1, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The Silero loop and the convs are chains of small ops: with several
    test workers on the host, torch's intra-op threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def two_voices(seconds=12.0, seed=0, rate=16000):
    """Two harmonic sources of different F0 with noise, taking turns of 1.8 s
    with 0.6 s of near-silence between turns."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    turn = (t // 2.4).astype(int)
    speaking = (t % 2.4) < 1.8
    f0 = np.where(turn % 2 == 0, 110.0, 260.0)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    wave = sum(np.sin(k * phase) / k for k in range(1, 7))
    return (0.25 * wave * speaking + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


class EnergyVAD:
    """A package's Silero run on the audio, with an energy decision a chunk
    laid over its probabilities, binarized by that package's own
    ``binarize``."""

    def __init__(self, silero, module):
        self.silero, self.module = silero, module
        self.probs = None

    def detect_speech(self, audio, sample_rate=16000):
        self.probs = np.asarray(self.silero.speech_probabilities(audio, sample_rate))
        n = len(self.probs)
        energy = np.abs(np.pad(audio, (0, n * 512 - len(audio)))).reshape(n, 512).mean(1)
        return self.module.binarize(np.where(energy > 0.05, 0.9, 0.05).astype(np.float32),
                                    self.module.VADConfig())


@pytest.fixture(scope="module")
def pipelines():
    silero = p_vad.init_params(3)
    tree = p_wes.init_wespeaker_params(np.random.default_rng(4), **WES_WIDTHS)
    rng = np.random.default_rng(5)
    for stage in tree["stages"]:
        for blk in stage:
            for k in ("bn1", "bn2"):
                shape = blk[k]["bias"].shape
                blk[k]["bias"] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    ref = (EnergyVAD(j_vad.SileroVAD(silero), j_vad),
           j_wes.WeSpeaker(jax.tree_util.tree_map(jnp.asarray, tree)))
    port = (EnergyVAD(p_vad.SileroVAD(silero, device="cpu"), p_vad),
            p_wes.WeSpeaker(tree, device="cpu"))
    return ref, port


def as_tuples(segs):
    return [(s.start, s.end, int(s.speaker)) for s in segs]


@pytest.mark.parametrize("num_speakers", [None, 2, 3])
def test_pipeline_matches_reference(pipelines, num_speakers):
    """Windows of 1.5 s at a 0.75 s hop over the speech regions, embedded in
    one batch, clustered (average linkage on cosine distance, the 0.35
    threshold or ``num_speakers``), merged: the segments and speakers equal
    the reference's."""
    (jv, jw), (pv, pw) = pipelines
    cfg = p_diar.DiarizationConfig()
    audio = two_voices()
    want = j_diar.DiarizationPipeline(jv, jw).diarize(audio, num_speakers=num_speakers)
    got = p_diar.DiarizationPipeline(pv, pw, cfg).diarize(audio, num_speakers=num_speakers)
    err = np.abs(pv.probs - jv.probs).max()
    assert err <= 1e-5, err
    assert got and as_tuples(got) == as_tuples(want)
    if num_speakers is not None:
        assert len({s.speaker for s in got}) == num_speakers


def test_linkage_is_clear_of_the_threshold(pipelines):
    """The windows' embeddings from both packages within 1e-4, and every
    merge distance of the average linkage at least 1e-4 from the 0.35
    threshold, so the labels do not hang on rounding."""
    from scipy.cluster.hierarchy import linkage
    from scipy.spatial.distance import squareform

    (jv, jw), (pv, pw) = pipelines
    audio = two_voices()
    segs = pv.detect_speech(audio)
    windows = []
    for seg in segs:                        # the pipeline's windows
        pos, s1 = int(seg.start * 16000), int(seg.end * 16000)
        while s1 - int(seg.start * 16000) >= 4800 and pos < s1:
            end = min(pos + 24000, s1)
            if end - pos >= 4800:
                windows.append(audio[pos:end])
            if end >= s1:
                break
            pos += 12000
    assert len(windows) >= 10
    got, want = pw.embed_batch(windows), np.asarray(jw.embed_batch(windows))
    assert np.abs(got - want).max() <= 1e-4
    dist = np.clip(1.0 - got @ got.T, 0.0, None)
    np.fill_diagonal(dist, 0.0)
    merges = linkage(squareform(dist, checks=False), method="average")[:, 2]
    assert np.abs(merges - 0.35).min() > 1e-4, merges


def test_der_of_the_port_matches(pipelines):
    """The port's hypothesis scored against a reference labelling built
    from the turns: the copied DER gives the JAX package's numbers."""
    _, (pv, pw) = pipelines
    hyp = p_diar.DiarizationPipeline(pv, pw).diarize(two_voices(), num_speakers=2)
    truth = [p_diar.pipeline.DiarizedSegment(2.4 * i, 2.4 * i + 1.8, i % 2) for i in range(5)]
    jtruth = [j_diar.pipeline.DiarizedSegment(s.start, s.end, s.speaker) for s in truth]
    jhyp = [j_diar.pipeline.DiarizedSegment(s.start, s.end, s.speaker) for s in hyp]
    for collar in (0.0, 0.25):
        got = p_diar.diarization_error_rate(truth, hyp, collar=collar)
        assert got == j_diar.diarization_error_rate(jtruth, jhyp, collar=collar)
        assert 0.0 <= got["der"] <= 1.0


@pytest.mark.parametrize("seed", range(3))
def test_clustering_matches(seed):
    """Average linkage with the threshold, with ``num_clusters`` and with
    the speaker cap forcing merges: the labels equal the reference's."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, 8))
    emb = centers[rng.integers(0, 4, 30)] + 0.3 * rng.standard_normal((30, 8))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for kw in ({"threshold": 0.35}, {"threshold": 0.35, "num_clusters": 2},
               {"threshold": 0.05, "max_clusters": 3}):
        np.testing.assert_array_equal(p_diar.agglomerative_cluster(emb, **kw),
                                      j_diar.agglomerative_cluster(emb, **kw))


def test_from_pretrained_resolves_to_the_ports_models(monkeypatch):
    """``from_pretrained`` builds the port's Silero and WeSpeaker (their own
    default ids), and the pipeline reaches the
    port's batched WeSpeaker."""
    seen = []

    def fake(cls):
        def from_pretrained(*a, **kw):
            seen.append(cls.__name__)
            return cls.init_random(device="cpu") if cls is p_vad.SileroVAD else \
                cls(p_wes.init_wespeaker_params(np.random.default_rng(0), **WES_WIDTHS),
                    device="cpu")
        return from_pretrained

    monkeypatch.setattr(p_vad.SileroVAD, "from_pretrained", fake(p_vad.SileroVAD))
    monkeypatch.setattr(p_wes.WeSpeaker, "from_pretrained", fake(p_wes.WeSpeaker))
    pipe = p_diar.DiarizationPipeline.from_pretrained()
    assert seen == ["SileroVAD", "WeSpeaker"]
    calls = []
    batch = pipe.embedder.embed_batch
    monkeypatch.setattr(pipe.embedder, "embed_batch", lambda *a: calls.append(1) or batch(*a))
    pipe.vad = EnergyVAD(pipe.vad, p_vad)
    assert pipe.diarize(two_voices(6.0)) and calls == [1]
    assert dataclasses.asdict(pipe.cfg) == dataclasses.asdict(j_diar.DiarizationConfig())
