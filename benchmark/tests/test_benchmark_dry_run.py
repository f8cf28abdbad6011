"""A whole run of the harness on the CPU at a tiny configuration, past the
look for a chip, and the check coming out false with the timed path broken."""

import json
import time

import pytest

from benchmark import harness
from benchmark.faults import FAULTS, plant

E2E = {"xrt", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run(tiny_cell, trace):
    result = harness.run_cell(tiny_cell, 2 ** 33 + 5, 0.2, bool(trace), "cpu",
                              time.perf_counter())
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0 and result["attempted"] % tiny_cell.traffic["batch"] == 0
    assert result["device"]["platform"] == "cpu" and result["device"]["count"] == 1
    if trace:
        # no profiler trace on the CPU: only the host spans and mfu
        assert set(result["metrics"]) == {"stage_ms", "decode_step_ms", "mfu"}
    else:
        assert set(result["metrics"]) == E2E
        assert result["metrics"]["xrt"]["unit"] == "audio-s/s"
    assert result["checks"]["logit_gap"]["value"] <= result["checks"]["logit_gap"]["limit"]
    json.dumps(result)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_cell, fault):
    tiny_cell.traffic["check_requests"] = 100      # every request answered
    undo = plant(fault)
    try:
        result = harness.run_cell(tiny_cell, 11, 0.2, False, "cpu", time.perf_counter())
    finally:
        undo()
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
