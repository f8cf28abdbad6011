"""The benchmark, driven by ``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration (``configs`` entry,
whose ``file`` holds it; its ``family`` picks ``families/<family>.py``) and
a traffic mix (``traffic/<name>.json``; its ``driver`` picks
``drivers/<driver>.py``, the loop that sends it). Every metric, end to end
or per layer, is read by ``metrics/<name>.py``'s ``read(run)``, which
returns a number, or None where it finds nothing to read. A cell's limits
are ``limits/<cell>.json``. Adding a configuration, a mix, a metric or a
cell adds files and entries; no file here changes.

One run: set-up (counted as ``setup_s`` from the process's start), the
window that the mix's driver fills for ``seconds``, and then, once the
program's state is freed, the check. With ``trace`` the window records
host spans, one more batch runs under the profiler, and the metrics are
the cell's per-layer ones.
"""

from __future__ import annotations

import importlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

#: the published peaks of one H100 SXM (dense), and its memory rate
PEAKS = {"bf16_flops_s": 989e12, "hbm_bytes_s": 3.35e12}

#: top-level modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_asr_swift_tpu")


def load_benchmark(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: Path = REPO) -> SimpleNamespace:
    """The cell ``name`` with its configuration and traffic files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return SimpleNamespace(name=name, chips=cell["chips"], cfg=cfg, traffic=traffic,
                           limits=limits, end_to_end=e2e, per_layer=per_layer)


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    return importlib.import_module(f"benchmark.metrics.{name}").read


def family_module(family: str):
    return importlib.import_module(f"benchmark.families.{family}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, chips: int, peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}


def run_cell(cell: SimpleNamespace, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """One run of ``cell``; returns the result's object."""
    import torch

    device = torch.device(device)
    family = family_module(cell.cfg["family"])
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    runner = family.Runner(cell.cfg, cell.traffic, seed, device, log=log)
    runner.setup()
    setup_s = time.perf_counter() - t_start
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    runner.spans_on = trace
    window = driver.run(runner, cell.traffic, seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window: {window['batches']} batches, {window['attempted']} requests, "
        f"{window['window_s']:.3f} s; set-up {setup_s:.3f} s; peak {peak} bytes; batch walls (s) "
        + " ".join(f"{w:.3f}" for w in window["walls"]))
    info = device_info(device, cell.chips, peak)
    run = SimpleNamespace(cfg=cell.cfg, traffic=cell.traffic, peaks=PEAKS, setup_s=setup_s,
                          memory_peak_bytes=peak, profile=None,
                          spans=[s for s in runner.spans if s[0] < window["batches"]],
                          steps=runner.steps[:window["batches"]],
                          batch_samples=runner.batch_samples, **window)
    breakdown = None
    if trace and cuda:
        run.profile = runner.profiled_batch()
        from .trace import busy_us, idle_gaps, top_kernels

        info.update(busy_s=busy_us(run.profile) / 1e6, window_s=run.profile["wall_s"])
        breakdown = {"device_ops": top_kernels(run.profile),
                     "idle_gaps": idle_gaps(run.profile)}
    metrics: Dict[str, dict] = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    runner.release()
    found = runner.check()
    checks = {"failed": {"value": window["failed"], "limit": 0}}
    for name, limit in cell.limits["limits"].items():
        checks[name] = {"value": found[name], "limit": limit}
    correct = (window["attempted"] > 0 and found.get("checked_tokens", 0) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    log(f"checked {found.get('checked_tokens', 0)} served tokens")
    return result
