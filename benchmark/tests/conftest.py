"""Shared pieces of the benchmark's own tests: the checkout's root on the
path, and a tiny configuration of the Qwen3-ASR family for CPU runs."""

import copy
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: widths of the tiny configuration: every decoder product packable (in a
#: multiple of 64, both sides at least 128), so the packed path runs
TINY_ENCODER = dict(d_model=64, num_heads=4, ffn_dim=128, num_layers=2, output_dim=128,
                    downsample_hidden=24, conv_out_input_dim=24 * 16)
TINY_VOCAB = 512
TINY_DECODER = dict(vocab_size=TINY_VOCAB, hidden_size=128, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=64, intermediate_size=256)
TINY_TRAFFIC = {"driver": "closed_loop", "batch": 3, "clip_seconds": [3.0, 9.0], "max_tokens": 6,
                "sample_rate": 16000,
                "signal": {"segment_s": 0.25, "tones": 3, "hz": [100.0, 4000.0],
                           "amplitude": [0.02, 0.1], "noise": 0.01},
                "pool_batches": 2, "check_requests": 3}
#: the tiny configuration's limit on the widest logit gap: its sound runs
#: read 0.0-0.0095 over 12 seeds on the CPU, the faults of the dry-run test
#: 0.117 (half the batch), 0.48 (a state unchanged), 1.14 (a token altered)
TINY_LIMIT = 0.07


def tiny_config(base: str = "qwen3-asr-0.6b-4bit") -> dict:
    with open(REPO / "benchmark" / "configs" / f"{base}.json") as f:
        cfg = json.load(f)
    cfg["encoder"].update(TINY_ENCODER)
    cfg["decoder"].update(TINY_DECODER)
    v = TINY_VOCAB
    cfg["special_tokens"] = dict(
        audio_pad_id=v - 10, audio_start_id=v - 9, audio_end_id=v - 8, eos_id=v - 7,
        pad_id=v - 6, im_start_id=v - 5, asr_text_id=v - 4, system_id=1, user_id=2,
        assistant_id=3, newline_id=4)
    return cfg


@pytest.fixture
def tiny_cell():
    """A cell of the tiny configuration under the benchmark's own metrics."""
    from benchmark import harness

    bench = harness.load_benchmark()
    return SimpleNamespace(name="tiny", chips=1, cfg=tiny_config(),
                           traffic=copy.deepcopy(TINY_TRAFFIC),
                           limits={"limits": {"logit_gap": TINY_LIMIT}},
                           end_to_end=[m for m in bench["end_to_end"] if "workloads" not in m],
                           per_layer=[m for m in bench["per_layer"] if "workloads" not in m])


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
