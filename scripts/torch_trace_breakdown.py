#!/usr/bin/env python3
"""Where a decode step's host time and the device's idle time go: one
cell of the benchmark run with the port's tracer (``core/trace.py``) on.

A stopgap until the benchmark switches the tracer itself: once
``benchmark/families/qwen3_asr.py``'s ``Runner.spans_on`` calls
``trace.enable()``/``trace.disable()``, the four readers below move to
``benchmark/metrics/`` and this script and its ``traced_runner`` go.

    python3 scripts/torch_trace_breakdown.py --workload <cell> --seed <n> \\
        --seconds <s> [--tracer 0|1]
    python3 scripts/torch_trace_breakdown.py --overhead

from the root of a checkout, on a CUDA device. The run is the one
``benchmark/run.py --trace 1`` makes (set-up, the window of host spans,
one profiled batch, the check), with the program's tracer switched on
where the benchmark switches its own spans on and off at the release:
the tracer covers the window's batches and the profiled batch. The
benchmark's result line is printed as it is; the last line of output is
``{"program_trace": {...}}`` with four readings:

- ``decode_dispatch_ms``: the ``asr.step`` spans of the window's batches
  over their decode steps, the host's time to issue one step;
- ``decode_sample_ms``: the ``asr.sample`` spans, likewise;
- ``sync_wait_ms``: the ``asr.done_read`` and ``asr.fetch`` spans of a
  window batch, averaged over the batches: the host's time blocked on the
  device in one batch;
- ``idle_in_dispatch`` (%): of the profiled batch's device idle time,
  counted as ``benchmark/trace.py::idle_gaps`` counts it, the share whose
  gap began while the host was inside an ``asr.step`` span. None unless
  the profiled batch's ``asr.prestage`` span, put on the profiler's clock
  by ``trace.to_trace_ns``, lies within the benchmark's ``prestage`` host
  range with each end within 1 ms of the range's.

and beside them the profiled batch's kernels and launches, the spans a
batch, the spans dropped past the cap, the offsets of the
``asr.prestage`` span inside the ``prestage`` range, and the profiled
batch's idle seconds by the innermost span the host was in as each gap
began (``idle_by_span_s``), and ``sync_wait_ms`` split between the
``done`` reads and the fetch. With ``--tracer 0``
the tracer stays off and ``program_trace`` still reports the profiled
batch's kernels and launches, for comparing the two.

The window's batches are the first ``asr.batch`` roots recorded, as many
as the window ran; the profiled batch is the root after them.

``--overhead`` times a decode step's three span sites (``asr.step``
around ``asr.decoder`` and ``asr.sample``) on the host with the tracer
off and on, against the same loop without them: ns a site, best of 5.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
REPO = Path(__file__).resolve().parent.parent
#: how far each end of ``asr.prestage`` may lie inside the benchmark's range
ALIGN_US = 1000.0


def batch_roots(spans) -> list:
    """The ``asr.batch`` roots, in order of their start."""
    return [s for s in spans if s.parent is None and s.name == "asr.batch"]


def _ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def _per_step(spans, n: int, name: str):
    ids = {r.id for r in batch_roots(spans)[:n]}
    steps = sum(1 for s in spans if s.batch in ids and s.name == "asr.step")
    total = sum(_ms(s) for s in spans if s.batch in ids and s.name == name)
    return total / steps if steps else None


def decode_dispatch_ms(spans, n: int):
    """Host ms of an ``asr.step`` span, over the first ``n`` batches' steps."""
    return _per_step(spans, n, "asr.step")


def decode_sample_ms(spans, n: int):
    """Host ms of an ``asr.sample`` span, over the first ``n`` batches' steps."""
    return _per_step(spans, n, "asr.sample")


def sync_wait_ms(spans, n: int, names=("asr.done_read", "asr.fetch")):
    """Host ms a batch in ``names`` (the ``done`` reads and the fetch),
    averaged over the first ``n`` batches."""
    roots = batch_roots(spans)[:n]
    if not roots:
        return None
    ids = {r.id for r in roots}
    return sum(_ms(s) for s in spans if s.batch in ids and s.name in names) / len(roots)


def prestage_offsets(spans, n: int, profile: dict, to_trace):
    """(start, end) µs of batch ``n``'s ``asr.prestage`` span after the start
    and before the end of the profile's ``prestage`` host range, or None."""
    roots = batch_roots(spans)
    ranges = [r for r in profile["host_ranges"] if r[2] == "prestage"]
    if len(roots) <= n or len(ranges) != 1:
        return None
    root = roots[n]
    mine = [s for s in spans if s.batch == root.id and s.name == "asr.prestage"]
    if len(mine) != 1:
        return None
    p0, p1 = (t / 1e3 for t in to_trace(mine[0]))
    return p0 - ranges[0][0], ranges[0][1] - p1


def _on_trace(spans, root, to_trace, names=None) -> list:
    """(start µs, end µs, name) of ``root``'s spans, parents before children."""
    out = [(*(t / 1e3 for t in to_trace(s)), s.name) for s in spans
           if s.batch == root.id and (names is None or s.name in names)]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def idle_in_dispatch(spans, n: int, profile: dict, to_trace):
    """% of the profiled batch's (batch ``n``'s) device idle time whose gap
    began inside one of its ``asr.step`` spans; None unless its
    ``asr.prestage`` lines up with the profile's ``prestage`` range."""
    off = prestage_offsets(spans, n, profile, to_trace)
    if off is None or not all(0.0 <= o <= ALIGN_US for o in off):
        return None
    gaps = dict(_idle_gaps(profile, _on_trace(spans, batch_roots(spans)[n], to_trace,
                                              ("asr.step",))))
    idle = sum(gaps.values())
    return 100.0 * gaps.get("asr.step", 0.0) / idle if idle > 0 else None


def _idle_gaps(profile: dict, host_spans: list) -> list:
    """``benchmark/trace.py::idle_gaps`` of ``profile`` with ``host_spans``
    in place of its host ranges: [[span, s], ...], every gap counted."""
    from benchmark.trace import idle_gaps

    return idle_gaps(dict(profile, host_ranges=host_spans), top=len(host_spans) + 1)


def idle_by_span(spans, n: int, profile: dict, to_trace) -> dict:
    """The profiled batch's device idle seconds by the innermost of its
    spans that the host was in as each gap began, largest first."""
    roots = batch_roots(spans)
    if len(roots) <= n:
        return {}
    return dict(_idle_gaps(profile, _on_trace(spans, roots[n], to_trace)))


def overhead(n: int = 20_000, repeat: int = 7) -> dict:
    """ns a span site, tracer off and on, over a loop without spans; the
    best of ``repeat`` runs of ``n`` steps, each on a fresh record."""
    import timeit

    from qwen3_asr_swift_tpu_torch.core import trace

    def bare():
        for _ in range(n):
            pass

    def sites():
        for _ in range(n):
            with trace.span("asr.step"):
                with trace.span("asr.decoder"):
                    pass
                with trace.span("asr.sample"):
                    pass

    def batch():   # the steps' spans are children of a root, as in a batch
        with trace.span("asr.batch"):
            sites()

    def best(f, on: bool) -> float:
        times = []
        for _ in range(repeat):
            trace.enable() if on else trace.disable()
            times.append(timeit.timeit(f, number=1))
        trace.disable()
        return min(times) / n * 1e9

    base = best(bare, False)
    off = best(sites, False)
    on = best(batch, True)
    return {"ns_a_site_off": (off - base) / 3, "ns_a_site_on": (on - base) / 3,
            "ns_a_loop_pass": base}


def traced_runner(base, on: bool):
    """``base`` (a family's ``Runner``) with the program's tracer switched
    with the benchmark's spans; the last instance is ``.last``."""
    from qwen3_asr_swift_tpu_torch.core import trace

    class Traced(base):
        last = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            Traced.last = self
            self.window_batches = 0
            self.profile = None

        @property
        def spans_on(self) -> bool:
            return self._spans_on

        @spans_on.setter
        def spans_on(self, value: bool) -> None:
            self._spans_on = value
            if on and value:
                trace.enable()
            else:
                trace.disable()

        def profiled_batch(self) -> dict:
            self.window_batches = len(batch_roots(trace.spans()))
            self.profile = super().profiled_batch()
            return self.profile

        def release(self) -> None:
            trace.disable()
            super().release()

    return Traced


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    p.add_argument("--overhead", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    if args.overhead:
        print(json.dumps(overhead()), flush=True)
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        p.error("--workload, --seed and --seconds are required without --overhead")
    import torch

    from benchmark import harness
    from qwen3_asr_swift_tpu_torch.core import trace

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    family = harness.family_module(cell.cfg["family"])
    family.Runner = traced_runner(family.Runner, bool(args.tracer))
    result = harness.run_cell(cell, args.seed, args.seconds, True, "cuda", T_START)
    runner = family.Runner.last
    spans, n, prof = trace.spans(), runner.window_batches, runner.profile
    print(json.dumps(result), flush=True)
    out = {"tracer": args.tracer, "profiled_kernels": len(prof["kernels"]),
           "launches": prof["launches"], "steps": prof["steps"]}
    if args.tracer:
        roots = batch_roots(spans)
        out.update(decode_dispatch_ms=decode_dispatch_ms(spans, n),
                   decode_sample_ms=decode_sample_ms(spans, n),
                   sync_wait_ms=sync_wait_ms(spans, n),
                   idle_in_dispatch=idle_in_dispatch(spans, n, prof, trace.to_trace_ns),
                   window_batches=n, roots=len(roots), spans=len(spans),
                   spans_per_batch=len(spans) / max(1, len(roots)), dropped=trace.dropped(),
                   prestage_offsets_us=prestage_offsets(spans, n, prof, trace.to_trace_ns),
                   idle_by_span_s=idle_by_span(spans, n, prof, trace.to_trace_ns),
                   sync_wait_ms_by_span={k: sync_wait_ms(spans, n, (k,))
                                         for k in ("asr.done_read", "asr.fetch")})
    print(json.dumps({"program_trace": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
