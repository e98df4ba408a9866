"""Spans and counters of the port's own work, read by the benchmark.

``span(name)`` marks a stretch of host work as a context manager. Spans
are off by default: ``span`` then returns one shared null context, with no
allocation, no clock read and no profiler range. Under ``tracing()`` each
span enters ``torch.profiler.record_function(name)``, so that a profiler
puts it on the timeline of the device's kernels, and is recorded here: its
name, its start and end on ``time.perf_counter_ns()``, its parent and the
id of its root, so every span of one call shares the root's id.

``count(name, n)`` adds to a named integer on the host. Counters are
always on and never read the device; call sites name them through this
module (``trace.count``), so a hook set on the module sees every addition.

The range path's spans: ``range`` (``RangeSearchEngine.range``, the root),
its stages ``range.phase1``, ``range.select``, ``range.phase2`` and
``range.result`` (with ``result.rerank`` inside), and in each search loop
``walk.sync`` (the loop's test) and ``walk.step`` (one iteration's work,
``walk.merge`` inside). Its counters: ``host_syncs`` (every blocking read
of the device, counted where it happens), ``walk.beam_iters`` and
``walk.greedy_iters`` (the iterations of each loop).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import torch

_NULL = contextlib.nullcontext()
_on = False
_records: list = []
_ids = itertools.count(1)
_local = threading.local()      # .stack: the open spans of this thread
_counts: dict = {}
_count_lock = threading.Lock()


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: int         # the enclosing span's id, 0 for a root
    root: int           # the outermost enclosing span's id (its own for a root)
    start_ns: int
    end_ns: int = 0     # 0 while the span is open

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _Open:
    """One recorded span, entered and left once."""

    __slots__ = ("name", "span", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._range.__enter__()
        i = next(_ids)
        up = stack[-1] if stack else None
        sp = Span(self.name, i, up.id if up else 0, up.root if up else i,
                  time.perf_counter_ns())
        stack.append(sp)
        _records.append(sp)
        self.span = sp
        return sp

    def __exit__(self, *exc):
        self.span.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around a stretch of work named ``name``: the
    shared null context while spans are off."""
    if not _on:
        return _NULL
    return _Open(name)


@contextlib.contextmanager
def tracing():
    """Spans on within this scope, for every thread."""
    global _on
    prev, _on = _on, True
    try:
        yield
    finally:
        _on = prev


def spans() -> list:
    """The spans recorded since the last ``reset``, in the order they
    started."""
    return list(_records)


def reset() -> None:
    _records.clear()


def summary(recorded=None) -> dict:
    """name -> (count, total ns, self ns) over closed spans, where a span's
    self time is its duration less its children's."""
    recorded = spans() if recorded is None else recorded
    closed = [s for s in recorded if s.end_ns]
    child: dict = {}
    for s in closed:
        if s.parent:
            child[s.parent] = child.get(s.parent, 0) + s.duration_ns
    out: dict = {}
    for s in closed:
        n, tot, own = out.get(s.name, (0, 0, 0))
        out[s.name] = (n + 1, tot + s.duration_ns,
                       own + s.duration_ns - child.get(s.id, 0))
    return out


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (on the host)."""
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    with _count_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _count_lock:
        _counts.clear()


def card_syncs(fn) -> list:
    """Run ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")`` (on a
    CUDA card) and return, for each synchronizing call the card reports,
    the innermost frame of the port's own code at it (None where none of
    its code was on the stack). A run of the range path should report as
    many port frames as it adds to ``host_syncs``. The mode is PyTorch's
    prototype: it reports the syncs its operations make, and may miss
    others."""
    import traceback
    import warnings
    seen: list = []

    def hook(message, *args, **kw):
        if "called a synchronizing" in str(message):   # not the mode's prototype notice
            mine = [f for f in traceback.extract_stack()
                    if "repro_torch" in f.filename and f.filename != __file__]
            seen.append(mine[-1] if mine else None)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return seen
