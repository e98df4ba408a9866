"""The program's own spans, read two ways over the traced batches.

The program (``repro_torch.trace``) marks its stages with spans: off by
default, and recorded, each also as a ``torch.profiler.record_function``
range, under ``trace.tracing()``. Two passes read them, beside the three of
``trace.py``, which run with spans off and stay as they are:

(a) ``span_pass``: spans on, no profiler. Each span's count, total and
    self time by the program's own clock, and the program's counters over
    the same batches.
(b) ``attribution_pass``: host and device under the profiler, spans on.
    Each device interval (kernel, copy, set) goes to the innermost program
    span that launched it, by the profiler's own link: the launching
    operation's correlation (``linked_correlation_id``), or else the
    correlation of the runtime call that launched it; never by matching
    host and device timestamps, since the host tracer slows the host and
    leaves the device's intervals as they were. A span's busy time is the
    union of the device intervals launched inside it (its children's
    included), never a sum of kernel times. Each idle gap of the device
    inside a batch is named by the innermost program span running on the
    host at its midpoint (``outside`` when no span was).

Nothing here runs in a run of a cell (``cell.py`` calls none of it);
``probe_spans.py`` runs both passes on a cell's set-up and prints them.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

from .trace import BATCH_RANGE, STEP_RANGE, _union, busy

OUTSIDE = "outside"
# the stages of a walk, whose device time is the walk's
WALK_STAGES = ("range.phase1", "range.select", "range.phase2")


@dataclasses.dataclass(frozen=True)
class HostEvent:
    name: str
    start: float            # seconds on the profiler's clock
    end: float
    thread: int
    corr: int               # the event's own correlation id


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    name: str
    start: float
    end: float
    corr: int               # the runtime call's correlation id
    linked: int             # the launching operation's correlation id (0: none)


class _Tree:
    """The program's spans of one thread, nested by the host's clock (a
    span opens and closes inside its parent, on one thread)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s.start, -s.end))
        self.starts = [s.start for s in self.spans]
        self.parent = []
        stack = []
        for i, s in enumerate(self.spans):
            while stack and self.spans[stack[-1]].end < s.end:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float) -> int:
        """The innermost span open at ``t`` (-1: none)."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i].end < t:
            i = self.parent[i]
        return i

    def chain(self, i: int) -> tuple:
        out = []
        while i >= 0:
            out.append(self.spans[i].name)
            i = self.parent[i]
        return tuple(out)


@dataclasses.dataclass
class Attribution:
    intervals: list         # (start, end, chain): chain innermost span first, () outside
    idle: dict              # innermost span at the gap's midpoint -> idle seconds
    linked: dict            # how each device interval was linked -> count
    batches: int

    def busy_in(self, names) -> float:
        """Seconds of device work launched inside any span named in
        ``names`` (a union: an interval inside two of them counts once)."""
        names = set(names)
        return busy([(None, s, e) for s, e, ch in self.intervals if names & set(ch)])

    def busy_by_span(self) -> dict:
        """name -> (busy seconds of the launches inside it, its children's
        included; busy seconds of those whose innermost span it is), with
        ``outside`` for the launches of no span."""
        own: dict = {}
        for s, e, ch in self.intervals:
            own.setdefault(ch[0] if ch else OUTSIDE, []).append((None, s, e))
        names = sorted({n for _, _, ch in self.intervals for n in ch})
        out = {n: (self.busy_in([n]), busy(own.get(n, []))) for n in names}
        if OUTSIDE in own:
            out[OUTSIDE] = (busy(own[OUTSIDE]),) * 2
        return out


def attribute(host: list, device: list, span_names, batch_name: str = BATCH_RANGE
              ) -> Attribution:
    """Device intervals to the spans that launched them, and the device's
    idle gaps inside each ``batch_name`` range to the span at their
    midpoint. ``host`` holds every host event of the trace (the program's
    spans are those named in ``span_names``), ``device`` every device
    interval."""
    span_names = set(span_names)
    # a range's mirror on the device timeline spans its work: not work
    ranges = span_names | {batch_name}
    device = [d for d in device if d.name not in ranges and not d.name.startswith(STEP_RANGE)]
    by_thread: dict = {}
    for h in host:
        if h.name in span_names:
            by_thread.setdefault(h.thread, []).append(h)
    trees = {th: _Tree(sp) for th, sp in by_thread.items()}
    runtime = {h.corr: h for h in host if h.corr and h.name.startswith("cu")}
    ops = {h.corr: h for h in host
           if h.corr and h.name not in span_names and not h.name.startswith("cu")}
    spans_by_corr = {}
    for th, tree in trees.items():
        for i, s in enumerate(tree.spans):
            if s.corr:
                spans_by_corr[s.corr] = (th, i)

    def chain_at(thread, t):
        tree = trees.get(thread)
        return tree.chain(tree.at(t)) if tree else ()

    intervals, linked = [], {"operation": 0, "runtime": 0, "none": 0}
    for d in device:
        if d.linked and d.linked in spans_by_corr:      # launched by the span itself
            th, i = spans_by_corr[d.linked]
            ch, how = trees[th].chain(i), "operation"
        elif d.linked and d.linked in ops:              # by an operation inside a span
            op = ops[d.linked]
            ch, how = chain_at(op.thread, op.start), "operation"
        elif d.corr in runtime:                         # by a runtime call inside a span
            rt = runtime[d.corr]
            ch, how = chain_at(rt.thread, rt.start), "runtime"
        else:
            ch, how = (), "none"
        linked[how] += 1
        intervals.append((d.start, d.end, ch))

    idle: dict = {}
    for b in (h for h in host if h.name == batch_name):
        union = _union([(max(s, b.start), min(e, b.end)) for s, e, _ in intervals
                        if e > b.start and s < b.end])
        edges = [b.start] + [x for iv in union for x in iv] + [b.end]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                ch = chain_at(b.thread, (g0 + g1) / 2)
                key = ch[0] if ch else OUTSIDE
                idle[key] = idle.get(key, 0.0) + (g1 - g0)
    n_batches = sum(1 for h in host if h.name == batch_name)
    return Attribution(intervals=intervals, idle=idle, linked=linked, batches=n_batches)


def profiler_events(prof) -> tuple[list, list]:
    """(host events, device intervals) of a finished ``torch.profiler``
    run, from its raw events (which keep the correlation links). The
    ranges' mirrors on the device timeline are left to ``attribute``."""
    from torch.autograd import DeviceType
    host, device = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() / 1e9
        e = s + ev.duration_ns() / 1e9
        if ev.device_type() == DeviceType.CPU:
            host.append(HostEvent(ev.name(), s, e, ev.start_thread_id(), ev.correlation_id()))
        elif e > s:
            device.append(DeviceEvent(ev.name(), s, e, ev.correlation_id(),
                                      ev.linked_correlation_id()))
    return host, device


def span_pass(run_batch, steps) -> tuple[float, dict, dict]:
    """(a): ``run_batch(step)`` for each step with spans on; returns (the
    batches' walls by the host's clock, ``trace.summary()`` over them, the
    counters' additions over them)."""
    from repro_torch import trace
    trace.reset()
    before = trace.counters()
    wall = 0.0
    with trace.tracing():
        for step in steps:
            t0 = time.perf_counter()
            run_batch(step)
            wall += time.perf_counter() - t0
    after = trace.counters()
    summ = trace.summary()
    trace.reset()
    return wall, summ, {k: v - before.get(k, 0) for k, v in after.items()}


def attribution_pass(run_batch, active: int) -> Attribution:
    """(b): ``active`` calls of ``run_batch(step)`` (steps 1..active) under
    host and device tracing with spans on, after one call that warms the
    tracer up (step 0), as ``trace.traced`` does."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import trace

    from .trace import _device_activity
    trace.reset()
    with trace.tracing(), profile(
            activities=sorted({ProfilerActivity.CPU, _device_activity()}, key=str),
            schedule=schedule(wait=0, warmup=1, active=active, repeat=1)) as prof:
        for step in range(active + 1):
            with record_function(BATCH_RANGE):
                run_batch(step)
            prof.step()
    names = {s.name for s in trace.spans()}
    trace.reset()
    host, device = profiler_events(prof)
    return attribute(host, device, names)


def readings(summ: dict, counted: dict, attr: Attribution, batches: int) -> dict:
    """The five numbers the program's spans and counters give a batch:
    ``host_syncs_per_batch`` and ``greedy_iters`` (counters),
    ``walk_host_us_per_iter`` (``walk.step``'s host time, total and self,
    over the iterations it ran), ``walk_device_ms`` and
    ``merge_device_ms`` (device busy time launched inside the walk's
    stages and inside ``walk.merge``)."""
    out = {"host_syncs_per_batch": counted.get("host_syncs", 0) / batches,
           "greedy_iters": counted.get("walk.greedy_iters", 0) / batches}
    n, total, own = summ.get("walk.step", (0, 0, 0))
    if n:
        out["walk_host_us_per_iter"] = total / n / 1e3
        out["walk_host_self_us_per_iter"] = own / n / 1e3
    if attr.batches:
        out["walk_device_ms"] = 1e3 * attr.busy_in(WALK_STAGES) / attr.batches
        out["merge_device_ms"] = 1e3 * attr.busy_in(["walk.merge"]) / attr.batches
    return out
