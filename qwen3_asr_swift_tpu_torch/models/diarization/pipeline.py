"""Speaker diarization: VAD → segmentation → embeddings → clustering.

TPU-native analog of the reference's pipeline
(reference: Sources/SpeechVAD/DiarizationPipeline.swift:78-278,
DiarizationHelpers.swift:83-168): speech regions from VAD, fixed-size
sliding embedding windows within each region, per-window speaker
embeddings (batched through the embedding model), constrained
agglomerative clustering on cosine distance, then merge/compact of
adjacent same-speaker segments.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ...core import DiarizedSegment, SpeakerDiarizationModel, SpeakerEmbeddingModel, SpeechSegment


@dataclasses.dataclass(frozen=True)
class DiarizationConfig:
    window_s: float = 1.5
    hop_s: float = 0.75
    min_segment_s: float = 0.3
    cluster_threshold: float = 0.35  # cosine distance for agglomerative stop
    max_speakers: int = 10


def agglomerative_cluster(embeddings: np.ndarray, threshold: float,
                          num_clusters: Optional[int] = None, max_clusters: int = 10) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine distance
    (reference: DiarizationHelpers agglomerative clustering).
    embeddings: [N, D] L2-normalized. Returns labels [N]."""
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, np.int32)
    if n == 1:
        return np.zeros(1, np.int32)
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    # O(n² log n) via scipy — the previous per-merge Python rescan was
    # O(n³)+ and unusable past a few hundred windows (an hour of audio is
    # ~4800 windows)
    dist = np.clip(1.0 - embeddings @ embeddings.T, 0.0, None)
    np.fill_diagonal(dist, 0.0)
    z = linkage(squareform(dist, checks=False), method="average")
    if num_clusters is not None:
        raw = fcluster(z, t=max(1, num_clusters), criterion="maxclust")
    else:
        raw = fcluster(z, t=threshold, criterion="distance")
        if raw.max() > max_clusters:
            # same forcing the merge loop applied: past the threshold keep
            # merging until the speaker cap holds
            raw = fcluster(z, t=max_clusters, criterion="maxclust")

    # stable speaker ids ordered by first appearance
    labels = np.zeros(n, np.int32)
    seen: dict = {}
    for i, r in enumerate(raw):
        if r not in seen:
            seen[r] = len(seen)
        labels[i] = seen[r]
    return labels


class DiarizationPipeline(SpeakerDiarizationModel):
    def __init__(self, vad, embedder: SpeakerEmbeddingModel,
                 config: DiarizationConfig = DiarizationConfig()):
        self.vad = vad
        self.embedder = embedder
        self.cfg = config
        self._loaded = True

    @classmethod
    def from_pretrained(cls, model_id: str = "", **kw) -> "DiarizationPipeline":
        from ..silero_vad import SileroVAD
        from ..speaker import WeSpeaker

        return cls(SileroVAD.from_pretrained(), WeSpeaker.from_pretrained(), **kw)

    def diarize(self, audio: np.ndarray, sample_rate: int = 16000,
                num_speakers: Optional[int] = None, **kwargs) -> Sequence[DiarizedSegment]:
        if sample_rate != 16000:
            from ...audio.resample import resample

            audio = resample(audio.astype(np.float32), sample_rate, 16000)
            sample_rate = 16000
        sr = sample_rate
        cfg = self.cfg

        speech: Sequence[SpeechSegment] = self.vad.detect_speech(audio, sr)
        windows: List[tuple] = []  # (start_s, end_s, samples)
        win = int(cfg.window_s * sr)
        hop = int(cfg.hop_s * sr)
        for seg in speech:
            s0 = int(seg.start * sr)
            s1 = int(seg.end * sr)
            if s1 - s0 < int(cfg.min_segment_s * sr):
                continue
            pos = s0
            while pos < s1:
                end = min(pos + win, s1)
                if end - pos >= int(cfg.min_segment_s * sr):
                    windows.append((pos / sr, end / sr, audio[pos:end]))
                if end >= s1:
                    break
                pos += hop

        if not windows:
            return []

        if hasattr(self.embedder, "embed_batch"):
            # one batched program for the whole window sweep (N dispatches
            # → 1; windows share a bucket, so one compile)
            embs = np.asarray(self.embedder.embed_batch([w[2] for w in windows], sr))
        else:
            embs = np.stack([self.embedder.embed(w[2], sr) for w in windows])
        labels = agglomerative_cluster(embs, cfg.cluster_threshold, num_speakers, cfg.max_speakers)

        # merge adjacent same-speaker windows (reference: merge/compact)
        segments: List[DiarizedSegment] = []
        for (start, end, _), label in zip(windows, labels):
            if segments and segments[-1].speaker == label and start <= segments[-1].end + cfg.hop_s:
                segments[-1] = DiarizedSegment(segments[-1].start, max(end, segments[-1].end), label)
            else:
                segments.append(DiarizedSegment(start, end, int(label)))
        return segments


# ---------------------------------------------------------------------------
# DER scoring (reference: Sources/SpeechVAD/DERScoring.swift)
# ---------------------------------------------------------------------------

def diarization_error_rate(reference: Sequence[DiarizedSegment],
                           hypothesis: Sequence[DiarizedSegment],
                           collar: float = 0.25, step: float = 0.01) -> dict:
    """Frame-based DER with optimal speaker mapping (Hungarian on overlap).

    Returns {"der", "miss", "false_alarm", "confusion"} as fractions of
    reference speech time."""
    if not reference:
        return {"der": 0.0, "miss": 0.0, "false_alarm": 0.0, "confusion": 0.0}
    end = max([s.end for s in reference] + [s.end for s in hypothesis] + [0.0])
    n = int(np.ceil(end / step)) + 1

    def rasterize(segs):
        grid = np.full(n, -1, np.int32)
        for s in segs:
            grid[int(s.start / step) : int(s.end / step)] = s.speaker
        return grid

    ref = rasterize(reference)
    hyp = rasterize(hypothesis)

    # collar: ignore frames near reference boundaries
    ignore = np.zeros(n, bool)
    c = int(collar / step)
    for s in reference:
        for b in (s.start, s.end):
            lo = max(0, int(b / step) - c)
            ignore[lo : int(b / step) + c] = True
    keep = ~ignore
    ref, hyp = ref[keep], hyp[keep]

    ref_spk = sorted(set(ref[ref >= 0]))
    hyp_spk = sorted(set(hyp[hyp >= 0]))
    overlap = np.zeros((len(ref_spk), len(hyp_spk)))
    for i, r in enumerate(ref_spk):
        for j, h in enumerate(hyp_spk):
            overlap[i, j] = np.sum((ref == r) & (hyp == h))
    mapping = {}
    if overlap.size:
        from scipy.optimize import linear_sum_assignment

        ri, hj = linear_sum_assignment(-overlap)
        mapping = {hyp_spk[j]: ref_spk[i] for i, j in zip(ri, hj)}

    hyp_mapped = np.array([mapping.get(h, -2) if h >= 0 else -1 for h in hyp])
    ref_time = np.sum(ref >= 0)
    if ref_time == 0:
        return {"der": 0.0, "miss": 0.0, "false_alarm": 0.0, "confusion": 0.0}
    miss = np.sum((ref >= 0) & (hyp == -1))
    fa = np.sum((ref == -1) & (hyp >= 0))
    conf = np.sum((ref >= 0) & (hyp >= 0) & (hyp_mapped != ref))
    return {
        "der": float((miss + fa + conf) / ref_time),
        "miss": float(miss / ref_time),
        "false_alarm": float(fa / ref_time),
        "confusion": float(conf / ref_time),
    }
