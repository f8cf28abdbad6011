#!/usr/bin/env python3
"""The random weight draws of ``chip_smoke.py`` on the card, in one run.

    python3 scripts/torch_card_draws.py                  # the draws' seconds
    python3 scripts/torch_card_draws.py --seeds 0 1 2    # and the slice's checks a seed

Each of the slice's, the 1.7B TTS's and the aligner's trees is drawn twice:
with numpy from seed 0 and packed on the host (``quantize_tree_np``), as
the phases drew them before, then as they draw them now, on the card from
a seeded ``torch.Generator`` and packed there (``quantize_tree``). With
``--seeds`` the slice is then drawn on the card from each torch seed, and
``chip_smoke.py``'s phase step and phase groupdot's step (products
teacher-forced, the free-running logits beside) run on it. A line per
reading with the card's name and power limit; the last line is a JSON
summary. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from qwen3_asr_swift_tpu_torch.core.params import init_random_params  # noqa: E402
from qwen3_asr_swift_tpu_torch.models.qwen3_asr import CONFIG_SMALL  # noqa: E402
from qwen3_asr_swift_tpu_torch.models.qwen3_asr.config import ENCODER_ALIGNER  # noqa: E402
from qwen3_asr_swift_tpu_torch.models.qwen3_tts import CONFIG_17B  # noqa: E402
from qwen3_asr_swift_tpu_torch.models.qwen3_tts.code_predictor import init_cp_params  # noqa: E402
from qwen3_asr_swift_tpu_torch.models.qwen3_tts.codec import init_codec_params  # noqa: E402
from qwen3_asr_swift_tpu_torch.models.qwen3_tts.talker import init_talker_params  # noqa: E402


def tts_trees(rng):
    cfg = CONFIG_17B
    return (init_talker_params(rng, cfg.talker), init_cp_params(rng, cfg.code_predictor),
            init_codec_params(rng, cfg.codec))


def aligner_trees(seed, device=None):
    cfg = dataclasses.replace(CONFIG_SMALL, encoder=ENCODER_ALIGNER)
    trees = init_random_params(cfg, seed, quant_bits=4, device=device)
    h = cfg.decoder.hidden_size
    if device is None:
        head = np.random.default_rng(1).standard_normal((h, cfg.classify_num), dtype=np.float32)
    else:
        head = torch.randn((h, cfg.classify_num), generator=torch.Generator(device=device)
                           .manual_seed(1), device=device)
    return trees, head


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[],
                    help="torch seeds of the slice to run phase step and groupdot's step on")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_card_draws: torch sees no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    draws = {
        "slice": (lambda: init_random_params(CONFIG_SMALL, 0, quant_bits=4),
                  lambda: init_random_params(CONFIG_SMALL, 0, quant_bits=4, device=dev)),
        "tts": (lambda: tts_trees(np.random.default_rng(0)),
                lambda: tts_trees(torch.Generator(device=dev).manual_seed(0))),
        "align": (lambda: aligner_trees(0), lambda: aligner_trees(0, dev)),
    }
    timed(lambda: torch.randn(8, device=dev))          # the context, before any timing
    summary = {}
    for name, (before, now) in draws.items():
        before_s, out = timed(before)
        del out
        now_s, out = timed(now)
        del out
        torch.cuda.empty_cache()
        summary[name] = {"before_s": before_s, "now_s": now_s}
        print(f"{name}: as before {before_s:.2f} s, as now {now_s:.2f} s "
              f"(saved {before_s - now_s:.2f} s) on {card}", flush=True)
    steps = {}
    if args.seeds:
        import chip_smoke
        from qwen3_asr_swift_tpu_torch.ops import cuda_build

        cuda_build.library()
        for seed in args.seeds:
            weights, host = chip_smoke.make_weights(dev, seed)
            del weights
            steps[seed] = {}
            try:       # a reading over its limit is a reading too
                steps[seed]["step"] = chip_smoke.phase_step(host, label=f"seed {seed} step")
                steps[seed]["groupdot"] = chip_smoke.groupdot_step(host)
            except AssertionError as e:
                steps[seed]["failed"] = str(e)
            print(f"seed {seed}: {steps[seed]} (groupdot: teacher-forced logits, free-running "
                  f"logits, worst product, worst input) on {card}", flush=True)
    print(json.dumps({"draws": summary, "steps": steps, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
