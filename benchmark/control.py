#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card, at the cell's size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--faults none,half_batch]

For each seed, in one process: the cell's set-up, one batch of its
traffic through the program, the program freed, and then the cell's own
check. Without ``--fault`` the program runs as the configuration states
(its readings are the lower ones), and the control is read beside the
reference: the reference computed with every product's input rounded to
fp8 e4m3 (one scale a row), the step below the configuration's bf16
activations. For each other name of ``--faults`` the program runs with
that fault of ``benchmark/faults.py`` planted. Prints one JSON line a
fault and seed with every number the check compares, and the limits the
cell holds now.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)


def readings(cell, seed: int, device="cuda", fault=None) -> dict:
    """One seed's readings for ``cell``: the program's (under ``fault``,
    where one is named) and, without a fault, the control's."""
    from benchmark import faults, harness

    undo = faults.plant(fault) if fault else None
    try:
        family = harness.family_module(cell.cfg["family"])
        runner = family.Runner(cell.cfg, cell.traffic, seed, device)
        t0 = time.perf_counter()
        runner.setup()
        setup_s = time.perf_counter() - t0
        runner.run_batch()
    finally:
        if undo:
            undo()
    runner.release()
    t0 = time.perf_counter()
    found = runner.check(controls=() if fault else ("fp8_control",))
    found.update(seed=seed, fault=fault, setup_s=setup_s, check_s=time.perf_counter() - t0,
                 limits=cell.limits["limits"], failed=runner.failed)
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--faults", default="none",
                   help="comma-separated: none (the program as it is) or faults of "
                        "benchmark/faults.py")
    args = p.parse_args(argv)
    from benchmark import harness

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    for fault in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            got = readings(cell, seed, fault=None if fault == "none" else fault)
            print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
