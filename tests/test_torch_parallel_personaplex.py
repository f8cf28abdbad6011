"""``PersonaPlex.shard``: the port's tensor-parallel PersonaPlex over two
gloo ranks on the CPU, against the JAX package's replicated model.

One spawn of two ranks (one intra-op thread each, a join timeout) runs
every rank-side check; the JAX side runs in this process meanwhile. Both
packages take the same numpy weights, in fp32:

- ``config_tiny()`` at tp 2, greedy ``respond_diagnostic``: the agent
  codes and text tokens identical to the reference's, the samples within
  2e-4 of them (the reference's own tolerance for its tp run against its
  replicated one) and the per-frame text statistics within 1e-5;
- packed 4-bit at widths 128: the temporal layers and the text head cut
  as packed triples (K1's plain version on CPU tensors, its launch
  counter at 0), the depformer banks by parts (q|k|v, gate|value), with
  the same holds against one device's port (whose packed ``respond``
  ``tests/test_torch_personaplex.py`` holds to the reference's);
- a full-duplex session of three frames at tp 2: codes and audio equal to
  one device's session;
- every rank's results identical.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from qwen3_asr_swift_tpu_torch.models.personaplex import PersonaPlex, PersonaSampling
from qwen3_asr_swift_tpu_torch.models.personaplex import mimi as pmimi
from qwen3_asr_swift_tpu_torch.models.personaplex import model as pmodel
from qwen3_asr_swift_tpu_torch.parallel import spawn

WORLD = 2
CFG = pmodel.config_tiny()
SPF, SR = CFG.mimi.samples_per_frame, CFG.mimi.sample_rate
GREEDY = dict(audio_temperature=0.0, text_temperature=0.0, max_steps=9)
RESPOND = dict(max_extra_s=1.0, system_prompt=[5, 9, 2])
WIDE = dict(d_model=128, num_heads=4, head_dim=32, intermediate_size=128, text_vocab=128)
SAMPLES_TOL = 2e-4
STATS_TOL = 1e-5


def weights(cfg, seed):
    rng = np.random.default_rng(seed)
    return pmodel.init_personaplex_params(rng, cfg), pmimi.init_mimi_params(rng, cfg.mimi)


def cases():
    """(config, seed, quant bits) of the dense and the packed case."""
    return {"dense": (CFG, 0, None), "packed": (dataclasses.replace(CFG, **WIDE), 5, 4)}


def clip(frames, seed=1):
    return (0.2 * np.random.default_rng(seed).standard_normal(frames * SPF)).astype(np.float32)


def port_model(name):
    cfg, seed, bits = cases()[name]
    p, m = weights(cfg, seed)
    return PersonaPlex(cfg, p, m, device="cpu", dtype=torch.float32, quant_bits=bits)


def diag_run(model):
    got, diag = model.respond_diagnostic(clip(4), SR, sampling=PersonaSampling(**GREEDY),
                                         **RESPOND)
    return got.samples, {k: np.asarray(v) for k, v in diag.items()}


def session_run(model):
    session = model.realtime_session(PersonaSampling(**GREEDY), seed=0)
    audio = clip(3, seed=2)
    wavs, codes = [], []
    for i in range(3):
        wavs.append(session.push_frame(audio[i * SPF:(i + 1) * SPF]))
        codes.append(session.last_codes.cpu().numpy())
    return np.stack(codes), np.stack(wavs)


def rank_checks(rank):
    from qwen3_asr_swift_tpu_torch.ops.quant import K1_LAUNCHES
    from qwen3_asr_swift_tpu_torch.parallel import make_mesh

    mesh = make_mesh(tp=WORLD, dp=1)
    out = {}
    for name in cases():
        k1 = K1_LAUNCHES.value
        model = port_model(name).shard(mesh=mesh)
        p = model.params
        q = p["layers"][0]["q_proj"]
        out[name + "_shapes"] = {
            "q_rows": (q["codes"] if "codes" in q else q["kernel"].T).shape[0],
            "text_head": tuple(p["text_head"]["codes" if "codes" in p["text_head"]
                                              else "kernel"].shape),
            "in_proj": tuple(p["dep_layers"][0]["in_proj"].shape),
            "gating_out": tuple(p["dep_layers"][0]["gating_out"].shape),
            "heads_bank": tuple(p["dep_heads_bank"].shape),
        }
        out[name] = diag_run(model)
        out[name + "_k1"] = K1_LAUNCHES.value - k1
    out["session"] = session_run(port_model("dense").shard(mesh=mesh))
    return out


def jax_side():
    import jax.numpy as jnp

    from qwen3_asr_swift_tpu.models.personaplex import PersonaPlex as JaxPlex
    from qwen3_asr_swift_tpu.models.personaplex import PersonaSampling as JaxSampling
    from qwen3_asr_swift_tpu.models.personaplex import config_tiny as jax_tiny

    cfg, seed, _ = cases()["dense"]
    p, m = weights(cfg, seed)
    got, diag = JaxPlex(jax_tiny(), p, m, dtype=jnp.float32).respond_diagnostic(
        clip(4), SR, sampling=JaxSampling(**GREEDY), **RESPOND)
    return {"dense": (got.samples, {k: np.asarray(v) for k, v in diag.items()}),
            "packed": diag_run(port_model("packed"))}


@pytest.fixture(scope="module")
def runs():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, rank_checks, WORLD, device="cpu", timeout=300)
        ref = jax_side()
        return ranks.result(), ref


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("name", ["dense", "packed"])
def test_tp2_respond_matches_replicated_run(runs, name):
    ranks, ref = runs
    want_samples, want = ref[name]
    for r in ranks:
        samples, diag = r[name]
        np.testing.assert_array_equal(diag["agent_tokens"], want["agent_tokens"])
        np.testing.assert_array_equal(diag["text_tokens"], want["text_tokens"])
        for stat in ("text_top_logit", "text_entropy", "hidden_stats"):
            assert rel(diag[stat], want[stat]) < STATS_TOL, stat
        assert len(samples) == len(want_samples)
        np.testing.assert_allclose(samples, want_samples, atol=SAMPLES_TOL, rtol=0)
        assert r[name + "_k1"] == 0   # CPU tensors: K1's plain version
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name][0], ranks[0][name][0])


@pytest.mark.parametrize("name", ["dense", "packed"])
def test_tp2_cuts_temporal_layers_and_depformer_banks(runs, name):
    ranks, _ = runs
    cfg = cases()[name][0]
    dd, steps = cfg.dep_d_model, cfg.num_codebooks
    for r in ranks:
        shapes = r[name + "_shapes"]
        assert shapes["q_rows"] == cfg.num_heads * cfg.head_dim // WORLD
        assert shapes["in_proj"] == (steps, dd, 3 * dd // WORLD)
        assert shapes["gating_out"] == (steps, cfg.dep_ff // WORLD, dd)
        assert shapes["heads_bank"] == (steps, dd, cfg.audio_card // WORLD)
        head = shapes["text_head"]
        assert (head[0] if name == "packed" else head[1]) == cfg.text_vocab // WORLD


def test_tp2_session_equals_one_device(runs):
    ranks, _ = runs
    codes, wavs = session_run(port_model("dense"))
    for r in ranks:
        np.testing.assert_array_equal(r["session"][0], codes)
        np.testing.assert_allclose(r["session"][1], wavs, atol=1e-5 * np.abs(wavs).max(), rtol=0)
