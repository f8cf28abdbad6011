#!/usr/bin/env python3
"""Time a kernel of two trees of the PyTorch/CUDA port in turns on one GPU.

    python3 scripts/torch_k1_ab.py [--kernel k1|k3] OLD_TREE NEW_TREE
    python3 scripts/torch_k1_ab.py --k3-variants

Each tree is a directory that holds a ``qwen3_asr_swift_tpu_torch``
package, for instance one unpacked from ``git archive <commit>``. The trees
run in turns (old, new, new, old), each in a process of its own that builds
that tree's kernels and times the kernel through this checkout's
``chip_smoke.py`` with that tree's package:

- ``k1`` (the default): one decode step of K1 at 32 rows with bf16 x
  (``packed_pair``): a line per product, then one JSON line of the step's
  sums;
- ``k3``: K3 as that tree's decoder calls it (bf16 q and bf16 out; a tree
  whose wrapper has no ``out_dtype`` returns fp32, which its decoder cast
  to bf16) on phase k3's inputs at B 32 (the slice's rows) and B 16
  (beam's), operands cold in L2, checked against the plain version
  (``k3_case``): a line per case, then one JSON line of the tree's times.

``--k3-variants`` times copies of this checkout's K3 changed in their
source: another split size or ring depth, or a part of the work cut out
(the K/V copies zero-filled, q·k or p·V skipped). Each copy is built in a
temporary directory under the package's ``build/`` and runs in a process
of its own, between two runs of the unchanged kernel. A cut computes
garbage, so here no output is checked (``k3_inputs``, timed alone). It
shows which part of the kernel the time follows.

The last line is a JSON summary.
"""

from __future__ import annotations

import functools
import importlib.util
import inspect
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "qwen3_asr_swift_tpu_torch"
K3_SRC = "csrc/decode_attn_int8.cu"
#: --k3-variants: (name, file of the package, [(text in it, its replacement)])
K3_VARIANTS = (
    ("whole", K3_SRC, []),
    ("split 32 KB", "ops/attention_int8.py", [("SPLIT_BYTES = 49152", "SPLIT_BYTES = 32768")]),
    ("split 64 KB", "ops/attention_int8.py", [("SPLIT_BYTES = 49152", "SPLIT_BYTES = 65536")]),
    ("ring of 3", K3_SRC, [("kStages = 2;", "kStages = 3;")]),
    ("no K/V bytes", K3_SRC, [("const bool in = c < bytes;", "const bool in = false;")]),
    ("no q.k", K3_SRC, [("pass < P::T / P::KPP", "pass < 0")]),
    ("no p.V", K3_SRC, [("r < P::T / P::KG", "r < 0")]),
    ("no q.k, no p.V", K3_SRC, [("pass < P::T / P::KPP", "pass < 0"),
                                ("r < P::T / P::KG", "r < 0")]),
)


def load_smoke(tree: str):
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    return smoke, torch.device("cuda")


def run_k1(tree: str) -> dict:
    smoke, dev = load_smoke(tree)
    import torch

    from qwen3_asr_swift_tpu_torch.ops import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    _, step, _, _, _ = smoke.packed_pair(
        dev, "K1", quant.quant_matmul_cuda, quant.quant_matmul,
        smoke.k1_library, smoke.step_cases(32, 1, "bfloat16"), smoke.K1_TOL, seed=0,
        peak=smoke.K1_PEAK)
    return {"package": quant.__file__, **step}


def run_k3(tree: str, checked: bool) -> dict:
    smoke, dev = load_smoke(tree)
    import torch

    from qwen3_asr_swift_tpu_torch.ops import attention_int8

    k3 = attention_int8.decode_attention_int8
    if "out_dtype" in inspect.signature(k3).parameters:
        call = functools.partial(k3, out_dtype=torch.bfloat16)
    else:
        def call(*args):
            return k3(*args).to(torch.bfloat16)
    out = {"package": attention_int8.__file__}
    for b, seed in ((32, 1), (16, 2)):
        if checked:
            case = smoke.k3_case(dev, b, seed, call=call, yardsticks=False)
            ms, per_call, by_kernel = (case["device_ms"], case["kernels_per_call"],
                                       case["by_kernel"])
        else:
            _, ms, _, per_call, by_kernel = smoke.time_turns(
                [(call, smoke.k3_inputs(dev, b, seed))])[0]
        out.update({f"b{b}_device_ms": ms, f"b{b}_kernels_per_call": per_call,
                    f"b{b}_by_kernel": by_kernel})
    return out


def turns(kernel: str, trees) -> list:
    """Run ``kernel``'s timing for each tree, in order, a process each."""
    runs = []
    for tree in trees:
        out = subprocess.run([sys.executable, __file__, "--run", kernel, str(tree)],
                             capture_output=True, text=True)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            raise SystemExit(out.returncode)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    return runs


def k3_variants() -> None:
    build = ROOT / PKG / "build"   # listed in .gitignore
    build.mkdir(parents=True, exist_ok=True)
    variants = K3_VARIANTS + K3_VARIANTS[:1]
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        trees = []
        for i, (name, rel, subs) in enumerate(variants):
            tree = Path(tmp) / f"v{i}"
            shutil.copytree(ROOT / PKG, tree / PKG,
                            ignore=shutil.ignore_patterns("build", "__pycache__"))
            text = (tree / PKG / rel).read_text()
            for old, new in subs:
                if old not in text:
                    raise SystemExit(f"{name}: {old!r} not in {rel}")
                text = text.replace(old, new)
            (tree / PKG / rel).write_text(text)
            trees.append(tree)
        runs = turns("k3-unchecked", trees)
    print(json.dumps({"k3_variants_device_ms": [
        [name, r["b32_device_ms"], r["b16_device_ms"]]
        for (name, _, _), r in zip(variants, runs)]}))


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--run":
        kernel, tree = args[1:]
        row = run_k1(tree) if kernel == "k1" else run_k3(tree, kernel == "k3")
        print(json.dumps({"tree": tree, **row}), flush=True)
        return 0
    if args == ["--k3-variants"]:
        k3_variants()
        return 0
    kernel = "k1"
    if len(args) == 4 and args[0] == "--kernel" and args[1] in ("k1", "k3"):
        kernel, args = args[1], args[2:]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = args
    runs = turns(kernel, (old, new, new, old))
    if kernel == "k1":
        print(json.dumps({"k1_step_device_ms": [[r["tree"], r["device_ms"]] for r in runs],
                          "library_ms": [r["library_ms"] for r in runs]}))
    else:
        print(json.dumps({"k3_b32_device_ms": [[r["tree"], r["b32_device_ms"]] for r in runs],
                          "k3_b16_device_ms": [[r["tree"], r["b16_device_ms"]] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
