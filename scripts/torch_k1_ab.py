#!/usr/bin/env python3
"""Time kernel K1 of two trees of the PyTorch/CUDA port in turns on one GPU.

    python3 scripts/torch_k1_ab.py OLD_TREE NEW_TREE

Each tree is a directory that holds a ``qwen3_asr_swift_tpu_torch``
package, for instance one unpacked from ``git archive <commit>``. The trees
run in turns (old, new, new, old), each in a process of its own that builds
that tree's kernels and times one decode step of K1 at 32 rows with bf16 x
through ``chip_smoke.py``'s ``packed_pair`` (this checkout's script, that
tree's package): a line per product, then one JSON line of the step's sums.
The last line is a JSON summary of the four runs.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_tree(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from qwen3_asr_swift_tpu_torch.ops import quant

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, step, _, _, _ = smoke.packed_pair(
        torch.device("cuda"), "K1", quant.quant_matmul_cuda, quant.quant_matmul,
        smoke.k1_library, smoke.step_cases(32, 1, "bfloat16"), smoke.K1_TOL, seed=0,
        peak=smoke.K1_PEAK)
    print(json.dumps({"tree": tree, "package": quant.__file__, **step}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run_tree(sys.argv[2])
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = sys.argv[1:]
    runs = []
    for tree in (old, new, new, old):
        out = subprocess.run([sys.executable, __file__, "--run", tree], capture_output=True,
                             text=True)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(json.dumps({"k1_step_device_ms": [[r["tree"], r["device_ms"]] for r in runs],
                      "library_ms": [r["library_ms"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
