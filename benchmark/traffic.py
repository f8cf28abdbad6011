"""The one traffic generator: a traffic file's parameters and a seed → batches.

A traffic file (``traffic/<name>.json``) holds batches of clips:

- ``driver``: the loop that sends them, ``drivers/<driver>.py``;
- ``batch``: clips a batch;
- ``clip_seconds``: [least, most]; the lengths of a batch are the fixed
  grid ``least + (most - least) * (i + 0.5) / batch``, so every seed gives
  every batch the same set of lengths, in an order drawn from the seed;
- ``max_tokens``: the decode budget of every clip;
- ``sample_rate`` and ``signal``: each clip is a run of ``segment_s``
  segments, each the sum of ``tones`` sines at frequencies drawn
  log-uniform in ``hz`` with amplitudes uniform in ``amplitude``, plus
  Gaussian noise of std ``noise``; drawn on the device from the seed. A
  segment's spectrum changes as a syllable's does, so each clip's encoder
  output is its own (over white noise every clip looks alike);
- ``pool_batches``: distinct batches drawn at set-up, sent in turn;
- ``check_requests``: requests a run holds against the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .reference.qwen3_asr import derived_seed

#: draw streams of :func:`benchmark.reference.qwen3_asr.derived_seed`
ORDER_STREAM, AUDIO_STREAM, CHECK_STREAM = 10, 11, 12


def clip_samples(traffic: dict, seed: int, batch_index: int) -> List[int]:
    """Samples of each clip of one batch, in the seed's order."""
    lo, hi = traffic["clip_seconds"]
    n = traffic["batch"]
    grid = [round((lo + (hi - lo) * (i + 0.5) / n) * traffic["sample_rate"]) for i in range(n)]
    order = np.random.default_rng(derived_seed(seed, ORDER_STREAM, batch_index)).permutation(n)
    return [grid[i] for i in order]


def draw_batch(traffic: dict, seed: int, batch_index: int, device) -> List[np.ndarray]:
    """One batch of clips (float32 numpy, as the API takes them), drawn on
    ``device`` in a few calls over the whole batch and copied to the host
    once."""
    sizes = clip_samples(traffic, seed, batch_index)
    sig = traffic["signal"]
    sr = traffic["sample_rate"]
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, AUDIO_STREAM, batch_index))
    seg = round(sig["segment_s"] * sr)
    n = torch.tensor(sizes, device=device)
    clip = torch.repeat_interleave(torch.arange(len(sizes), device=device), n)
    local = torch.arange(int(n.sum()), device=device) - (torch.cumsum(n, 0) - n)[clip]
    segs = (n + seg - 1) // seg
    gseg = (torch.cumsum(segs, 0) - segs)[clip] + local // seg
    shape = (int(segs.sum()), sig["tones"])
    lo, hi = (float(np.log(f)) for f in sig["hz"])
    hz = torch.exp(torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo)
    amp = torch.rand(shape, generator=gen, device=device)
    amp = amp * (sig["amplitude"][1] - sig["amplitude"][0]) + sig["amplitude"][0]
    t = (local % seg).float()[:, None] / sr
    flat = (amp[gseg] * torch.sin(2 * np.pi * hz[gseg] * t)).sum(dim=-1)
    flat += sig["noise"] * torch.randn(flat.shape, generator=gen, device=device)
    flat = flat.cpu().numpy()
    out, off = [], 0
    for n in sizes:
        out.append(flat[off:off + n])
        off += n
    return out


def check_sample(traffic: dict, seed: int, requests: List[tuple]) -> List[int]:
    """Indices into ``requests`` ((batch, row, samples, tokens served)) to
    hold against the reference: ``check_requests`` of them drawn from the
    seed, the longest (most tokens, then most samples) always among them."""
    n = min(traffic["check_requests"], len(requests))
    if n == 0:
        return []
    longest = max(range(len(requests)), key=lambda i: (requests[i][3], requests[i][2]))
    rng = np.random.default_rng(derived_seed(seed, CHECK_STREAM))
    rest = [i for i in rng.permutation(len(requests)).tolist() if i != longest]
    return [longest] + rest[:n - 1]
