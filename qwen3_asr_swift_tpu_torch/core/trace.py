"""The port's tracer: named host spans on one clock, and the named counters
(each kernel's launches; the Qwen3-ASR decode loop's CUDA graph captures,
replays and eager steps).

Process-wide and off by default. ``span(name)`` is a context manager. While the tracer is off it returns one shared object whose
methods do nothing, so a span site costs a boolean test and two empty
calls: no clock read, no record. While it is on, each span closed is kept
in memory as a :class:`Span`:

    (id, parent id, batch id, name, start ns, end ns)

stamped with ``time.perf_counter_ns()``. The parent is the innermost span
open on the calling thread; the batch id is the id of the root of that
tree. Each root reads ``(time.time_ns(), time.perf_counter_ns())`` together
as it opens, and :func:`to_trace_ns` puts every span of its tree on the
Unix-epoch clock that ``torch.profiler`` stamps its host events with, so
the two clocks drift apart by at most one tree's length.

A span adds no device operation, no synchronisation and no device
allocation, and changes no path. It puts nothing into a profiler's trace
unless the tracer is on with ``annotate=True`` (:func:`annotating`, which
``core.logging.profile_trace`` uses): each span opened then is also a
``torch.profiler.record_function`` range.

    from qwen3_asr_swift_tpu_torch.core import trace

    trace.enable()
    model.transcribe_batch(clips)
    trace.disable()
    for s in trace.spans():
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms")
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Tuple

#: spans kept at most; those closed past it are counted by :func:`dropped`
CAP = 200_000

#: whether spans are recorded (read on every ``span`` call)
ON = False
_annotate = False
_records: List["Span"] = []
_dropped = 0
#: batch id → (time.time_ns(), time.perf_counter_ns()) read as its root opened
_anchors: Dict[int, Tuple[int, int]] = {}
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()
_counters: Dict[str, "LaunchCounter"] = {}


class Span(NamedTuple):
    """One closed span; times on ``time.perf_counter_ns()``."""

    id: int
    parent: Optional[int]
    batch: int
    name: str
    start_ns: int
    end_ns: int


class LaunchCounter:
    """Thread-safe count of one kernel's launches (the serving batcher
    runs two worker threads through the same wrappers), or of other events
    of the program. Each counter is registered under its name, which
    :func:`counters` reads; a later counter of the same name takes the
    name over. Inside :func:`held_launches` the calling thread's ``add``
    goes to the block's dict instead."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()
        _counters[name] = self

    def add(self, n: int = 1) -> None:
        held = getattr(_local, "held", None)
        if held is not None:
            held[self] = held.get(self, 0) + n
            return
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def counters() -> Dict[str, int]:
    """Every registered counter's value, by name."""
    return {name: c.value for name, c in list(_counters.items())}


#: ``models/qwen3_asr/model.py``'s decode loop: the steps captured as a CUDA
#: graph, the steps replayed from one, and the steps launched op by op
GRAPH_CAPTURES = LaunchCounter("asr.graph_captures")
GRAPH_REPLAYS = LaunchCounter("asr.graph_replays")
EAGER_STEPS = LaunchCounter("asr.eager_steps")


@contextmanager
def held_launches():
    """For the block, the calling thread's counts go to the dict it yields,
    ``{counter: n}``, and not to the counters; other threads count as
    before. A CUDA graph's capture launches nothing: each replay adds what
    the capture held (:func:`add_held`)."""
    outer = getattr(_local, "held", None)
    held = _local.held = {}
    try:
        yield held
    finally:
        _local.held = outer


def add_held(held: Dict["LaunchCounter", int]) -> None:
    """Add each count of a :func:`held_launches` dict to its counter."""
    for counter, n in held.items():
        counter.add(n)


class _Off:
    """The span every site gets while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open(stack: list) -> Tuple[int, Optional[int], int]:
    """(id, parent id, batch id) of a span opening on ``stack``; a root
    reads its clock anchor."""
    sid = next(_ids)
    if stack:
        return sid, stack[-1].id, stack[-1].batch
    anchor = (time.time_ns(), time.perf_counter_ns())
    with _lock:
        if len(_anchors) < CAP:
            _anchors[sid] = anchor
    return sid, None, sid


def _keep(rec: Span) -> None:
    """Keep ``rec`` if its tree has an anchor: it opened since the last
    :func:`enable`, under the cap."""
    global _dropped
    with _lock:
        if not ON or rec.batch not in _anchors:
            return
        if len(_records) < CAP:
            _records.append(rec)
        else:
            _dropped += 1


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "id", "parent", "batch", "start_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Open":
        stack = _stack()
        self.id, self.parent, self.batch = _open(stack)
        stack.append(self)
        self._range = None
        if _annotate:
            from torch.autograd.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        _keep(Span(self.id, self.parent, self.batch, self.name, self.start_ns, end))
        return False


def span(name: str):
    """``with span("asr.step"):`` records the block while the tracer is on."""
    if not ON:
        return OFF
    return _Open(name)


def enable(annotate: bool = False) -> None:
    """Clear the records and start recording; ``annotate`` also opens a
    ``record_function`` range for each span (for a profiler's trace)."""
    global ON, _annotate, _dropped
    with _lock:
        _records.clear()
        _anchors.clear()
        _dropped = 0
        _annotate = annotate
        ON = True


def disable() -> None:
    """Stop recording; the records stay readable."""
    global ON, _annotate
    with _lock:
        ON = False
        _annotate = False


@contextmanager
def annotating():
    """Record and annotate for the block, then restore the tracer's state:
    recording stays on, with its records, if it was on before."""
    global _annotate
    was_on, was_annotating = ON, _annotate
    if was_on:
        _annotate = True
    else:
        enable(annotate=True)
    try:
        yield
    finally:
        if was_on:
            _annotate = was_annotating
        else:
            disable()


def spans() -> List[Span]:
    """The spans recorded since :func:`enable`, in order of their start."""
    with _lock:
        out = list(_records)
    return sorted(out, key=lambda s: (s.start_ns, s.id))


def dropped() -> int:
    """Spans closed past :data:`CAP` since :func:`enable`, not kept (those
    of trees that opened past it are not counted)."""
    return _dropped


def to_trace_ns(s: Span) -> Tuple[int, int]:
    """``s``'s (start, end) on the Unix-epoch clock of ``torch.profiler``'s
    host events, through its root's anchor."""
    wall, perf = _anchors[s.batch]
    return wall + s.start_ns - perf, wall + s.end_ns - perf
