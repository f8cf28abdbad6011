"""The control on the card: the fp8 reference has to fail the check that the
program passes. At the longform cell's widths and check, on 16 clips a
seed (the cell sends 128), so that a test run holds it."""

import copy

import pytest

from benchmark import harness
from benchmark.control import readings

CELL = "qwen3-asr-0.6b-4bit.longform-30s"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's widths on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3600000001, 3600000002])
def test_control_fails_where_the_program_passes(card, seed):
    cell = harness.find_cell(harness.load_benchmark(), CELL)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(batch=16, pool_batches=1)
    got = readings(cell, seed, device=card)
    limits = cell.limits["limits"]
    assert got["failed"] == 0 and got["checked_tokens"] == 1600
    assert all(got[name] <= limit for name, limit in limits.items())
    assert any(got["fp8_control." + name] > limit for name, limit in limits.items())
