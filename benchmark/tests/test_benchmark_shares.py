"""Every share the readers give stays within 100 % on synthetic timings,
and the readers find nothing where there is nothing to read."""

import json
from types import SimpleNamespace

import pytest

from conftest import REPO
from benchmark import harness
from benchmark.costs import qwen3_asr as costs
from benchmark.families.qwen3_asr import DECODE_RANGE, K1_MARKS, K3_MARKS, expected_launches

ROWS, STEPS, SAMPLES, CACHE = 4, 3, 480000, 580


def config():
    with open(REPO / "benchmark" / "configs" / "qwen3-asr-0.6b-4bit.json") as f:
        return json.load(f)


def synthetic_run(slower: float, idle_us: float = 0.0):
    """A profiled batch whose K1 and K3 kernels each take ``slower`` times
    their bound, back to back inside one decode range, after ``idle_us``."""
    cfg = config()
    k1_s = costs.k1_decode_bound_s(cfg, ROWS, STEPS, harness.PEAKS)
    prompt = [costs.prompt_rows(cfg, SAMPLES)] * ROWS
    k3_s = costs.k3_decode_bound_s(cfg, prompt, STEPS, CACHE, harness.PEAKS)
    n1 = costs.k1_decode_launches(cfg, STEPS)
    n3 = expected_launches(cfg, STEPS)["k3"]
    t, kernels = idle_us, []
    for name, n, total in (("quant_matmul_kernel<4>", n1, k1_s), ("decode_attn_int8_split", n3,
                                                                   k3_s)):
        for _ in range(n):
            d = slower * total / n * 1e6
            kernels.append((name, t, t + d))
            t += d
    profile = {"kernels": kernels, "ranges": [(idle_us, t, DECODE_RANGE)],
               "host_ranges": [(0.0, t, DECODE_RANGE)], "window": (0.0, t), "wall_s": t / 1e6,
               "steps": STEPS, "rows": ROWS, "samples": [SAMPLES] * ROWS, "cache_len": CACHE,
               "launches": expected_launches(cfg, STEPS), "marks": {"k1": K1_MARKS,
                                                                    "k3": K3_MARKS},
               "decode_range": DECODE_RANGE}
    return SimpleNamespace(cfg=cfg, traffic={"max_tokens": STEPS + 1, "pool_batches": 1},
                           peaks=harness.PEAKS, spans=[], steps=[STEPS], profile=profile,
                           batches=1, walls=[t / 1e6], window_s=t / 1e6, audio_s=ROWS * 30.0,
                           setup_s=12.5, memory_peak_bytes=3 * 2 ** 30,
                           batch_samples=lambda b: [SAMPLES] * ROWS)


@pytest.mark.parametrize("slower", [1.0, 1.5, 7.0])
@pytest.mark.parametrize("metric", ["k1_roofline", "k3_roofline"])
def test_roofline_shares(metric, slower):
    share = harness.reader(metric)(synthetic_run(slower))
    assert share == pytest.approx(100.0 / slower, rel=1e-9)
    assert share <= 100.0 + 1e-9


@pytest.mark.parametrize("idle_us", [0.0, 1e3, 1e6])
def test_idle_share_within_bounds(idle_us):
    share = harness.reader("idle_share")(synthetic_run(1.0, idle_us))
    assert 0.0 <= share < 100.0


def test_mfu_within_the_peak():
    run = synthetic_run(1.0)
    flops = costs.batch_flops(run.cfg, [SAMPLES] * ROWS, STEPS + 1)
    run.window_s = flops / harness.PEAKS["bf16_flops_s"]        # the fastest the card could go
    assert harness.reader("mfu")(run) == pytest.approx(100.0)
    run.window_s *= 3
    assert harness.reader("mfu")(run) == pytest.approx(100.0 / 3)


def test_miscounted_launches_read_nothing():
    run = synthetic_run(1.0)
    run.profile["launches"] = {"k1": 1, "k3": 0}
    assert harness.reader("k1_roofline")(run) is None
    assert harness.reader("k3_roofline")(run) is None


def test_no_profile_reads_nothing():
    run = synthetic_run(1.0)
    run.profile = None
    for name in ("encode_ms", "prefill_ms", "decode_device_ms", "k1_roofline", "k3_roofline",
                 "idle_share"):
        assert harness.reader(name)(run) is None


def test_k3_reads_nothing_on_a_float_cache():
    """A bf16 cache: the code counts no K3 launch, and none ran."""
    run = synthetic_run(1.0)
    run.cfg["serving"]["kv_dtype"] = "bfloat16"
    p = run.profile
    p["kernels"] = [k for k in p["kernels"] if not k[0].startswith("decode_attn_int8")]
    p["launches"] = expected_launches(run.cfg, STEPS)
    assert p["launches"]["k3"] == 0
    assert harness.reader("k3_roofline")(run) is None
    assert harness.reader("k1_roofline")(run) == pytest.approx(100.0)


def test_idle_share_over_the_window_walls_of_the_same_clips():
    """The profiled batch (index 4, pool entry 1 of 3) against the window's
    batches 1 and 4 - 3 = 1 only: batch 1's wall, not the profiler's."""
    run = synthetic_run(1.0)
    busy = run.profile["wall_s"]
    run.traffic["pool_batches"] = 3
    run.batches, run.walls = 4, [9.0, 2 * busy, 9.0, 9.0]
    run.profile["wall_s"] = 3 * busy                       # the profiler's own host cost
    assert harness.reader("idle_share")(run) == pytest.approx(50.0)
    run.walls = [9.0]                                      # no batch of those clips
    assert harness.reader("idle_share")(run) is None


def test_end_to_end_readers():
    run = synthetic_run(1.0)
    assert harness.reader("xrt")(run) == pytest.approx(ROWS * 30.0 / run.window_s)
    assert harness.reader("xrt_device_paced")(run) == harness.reader("xrt")(run)
    assert harness.reader("setup_s")(run) == 12.5
    assert harness.reader("peak_mem_gib")(run) == 3.0


def test_host_spans():
    run = synthetic_run(1.0)
    run.spans = [(0, "prestage", 0.0, 0.25), (0, "_gen_chunk", 1.0, 1.2), (0, "_all_done", 1.2,
                                                                           1.3)]
    assert harness.reader("stage_ms")(run) == pytest.approx(250.0)
    assert harness.reader("decode_step_ms")(run) == pytest.approx(300.0 / STEPS)
