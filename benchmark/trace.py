"""Reading a profiled window: device kernels by range, busy time, idle gaps.

The profiler's device events are read from its raw trace (the event tree
that ``prof.events()`` builds costs about a millisecond of host an event).
Each kernel goes to the innermost ``record_function`` range, named
``PREFIX + name``, whose span on the device holds the kernel's start, else
to "other". The window opens with 64 spin kernels in a range of their own,
left out of every result: a window's first events have been seen lost.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

PREFIX = "bench:"
OPENER = "(opener)"
WINDOW = "(window)"


def _raw_events(prof):
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
        (dev if e.device_type() == DeviceType.CUDA else host).append(span)
    return dev, host


def profile_window(run: Callable[[], None]) -> dict:
    """Run ``run()`` once under the profiler. Returns {"kernels": [(name,
    start µs, end µs)], "ranges": [(start, end, name)] on the device,
    "host_ranges": [(start, end, name)] on the host, "window": (start, end)
    on the trace's clock, "wall_s": host seconds of ``run`` to its
    device's end}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(PREFIX + OPENER):
            for _ in range(64):
                torch.cuda._sleep(300_000)
        torch.cuda.synchronize()
        with record_function(PREFIX + WINDOW):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    dev, host = _raw_events(prof)
    kernels, ranges = [], []
    for name, start, end in dev:
        if name.startswith(PREFIX):
            ranges.append((start, end, name[len(PREFIX):]))
        elif not name.startswith("spin_kernel"):
            kernels.append((name, start, end))
    host_ranges = sorted((s, e, n[len(PREFIX):]) for n, s, e in host if n.startswith(PREFIX))
    window = next(((s, e) for s, e, n in host_ranges if n == WINDOW), None)
    if window is None:
        raise RuntimeError("the profiler kept no host range of the window")
    kernels = [k for k in kernels if k[1] >= window[0]]
    return {"kernels": kernels, "ranges": sorted(ranges), "host_ranges": host_ranges,
            "window": window, "wall_s": wall}


def _innermost(spans: List[Tuple[float, float, str]]):
    """A lookup t → the name of the innermost span holding t, else None."""
    starts = [s for s, _, _ in spans]
    parent, open_ = [], []
    for j, (start, _, _) in enumerate(spans):
        while open_ and spans[open_[-1]][1] <= start:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(j)

    def find(t: float):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and t >= spans[i][1]:
            i = parent[i]
        return spans[i][2] if i >= 0 else None
    return find


def by_range(trace: dict) -> Dict[str, Dict[str, float]]:
    """{range: {kernel name: device µs}} ("other" outside every range)."""
    find = _innermost([r for r in trace["ranges"] if r[2] not in (OPENER, WINDOW)])
    out: Dict[str, Dict[str, float]] = {}
    for name, start, end in trace["kernels"]:
        into = out.setdefault(find(start) or "other", {})
        into[name] = into.get(name, 0.0) + end - start
    return out


def count_in(trace: dict, range_name: str, marks) -> int:
    """Kernels in ``range_name`` whose name holds one of ``marks``."""
    find = _innermost([r for r in trace["ranges"] if r[2] not in (OPENER, WINDOW)])
    return sum(1 for name, start, _ in trace["kernels"]
               if find(start) == range_name and any(m in name for m in marks))


def busy_us(trace: dict) -> float:
    """µs of the window in which some kernel ran (the union of their spans)."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(trace["kernels"], key=lambda k: k[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(trace: dict, top: int = 10) -> List[list]:
    """The device's idle time in the window, summed by the innermost host
    range the host was in when each gap began: [[range, s], ...], largest first."""
    find = _innermost([r for r in trace["host_ranges"] if r[2] not in (OPENER, WINDOW)])
    w0, w1 = trace["window"]
    t, gaps = w0, {}
    for _, s, e in sorted(trace["kernels"], key=lambda k: k[1]):
        if s > t:
            key = find(t) or "outside the ranges"
            gaps[key] = gaps.get(key, 0.0) + (s - t) / 1e6
        t = max(t, e)
    if w1 > t:
        key = find(t) or "outside the ranges"
        gaps[key] = gaps.get(key, 0.0) + (w1 - t) / 1e6
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]


def top_kernels(trace: dict, top: int = 10) -> List[list]:
    """[[kernel name (cut to 160 characters), device s], ...], largest first."""
    out: Dict[str, float] = {}
    for name, s, e in trace["kernels"]:
        out[name[:160]] = out.get(name[:160], 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]
