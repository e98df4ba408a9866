"""The traced batches: ``torch.profiler`` over a few batches after the
window, reduced to what the per-layer readers and the ``breakdown`` need.

The same ``active`` batches run three times:

0. untraced, each timed by the host's clock from its first call to the
   end of its ``torch.cuda.synchronize()``: ``window_s`` is the sum of
   those walls. The tracer's own hooks slow the host loop (a bulk batch
   of 26,000 launches by about half), so the traced batches' walls would
   overstate the idle share; the program is deterministic and the
   batches are the same, so their device work is too;
1. the device alone (``ProfilerActivity.CUDA``), each after one batch
   that only warms the tracer up (the search's first kernel was seen
   missing from traces that started cold): ``busy_s`` is the union of
   the device intervals (kernels, copies, sets) recorded, never a sum of
   kernel times (overlaps count once), and each kernel's time counts
   towards its owner: the longest wrapper name its function name starts
   with (``expand_int8_bulk_kernel`` to ``expand_int8``);
2. host and device (``ProfilerActivity.CPU`` too), each batch inside a
   ``rangebench.batch`` range: only to name the idle gaps, the holes of
   the device's union inside the batches, each by the innermost host
   operation running at its midpoint, or ``python`` when the host was
   between operations. Recording every host operation slows the loop, so
   these gaps are longer than the untraced ones; their shares name the
   host's work, and no metric reads their length.
"""
from __future__ import annotations

import bisect
import dataclasses
import re

BATCH_RANGE = "rangebench.batch"
STEP_RANGE = "ProfilerStep"     # the schedule's own range around each step
_NAME = re.compile(r"(\w+)[<(]")
_NEAR = 64   # host operations looked back over for one that covers a gap


@dataclasses.dataclass
class Trace:
    window_s: float        # the batches' walls by the host's clock, untraced (pass 0)
    busy_s: float          # the union of their device intervals (pass 1)
    traced_s: float        # the same walls under the device tracer (pass 1)
    kernels: list          # (name, start_s, end_s) of every device interval (pass 1)
    gaps: dict             # host operation -> idle seconds (pass 2)

    def owner_time(self, owner: str, owners) -> tuple[int, float]:
        """(launches, device seconds) of the kernels ``owner`` launched."""
        n, t = 0, 0.0
        for name, s, e in self.kernels:
            if kernel_owner(name, owners) == owner:
                n += 1
                t += e - s
        return n, t

    def top_ops(self, k: int = 10) -> list:
        sums: dict = {}
        for name, s, e in self.kernels:
            key = name[:120]
            sums[key] = sums.get(key, 0.0) + (e - s)
        return sorted(([n, t] for n, t in sums.items()), key=lambda x: -x[1])[:k]

    def top_gaps(self, k: int = 10) -> list:
        return sorted(([n, t] for n, t in self.gaps.items()), key=lambda x: -x[1])[:k]


def kernel_owner(name: str, owners) -> str | None:
    """The wrapper a device kernel belongs to: the longest of ``owners``
    that the kernel's function name starts with, followed by ``_``."""
    m = _NAME.search(name)
    fname = m.group(1) if m else name
    best = None
    for o in owners:
        if fname.startswith(o + "_") and (best is None or len(o) > len(best)):
            best = o
    return best


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _split(events):
    """(host ops, device intervals, batch ranges) of ``prof.events()``."""
    from torch.autograd import DeviceType
    host, device, batches = [], [], []
    for ev in events:
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        ranged = ev.name == BATCH_RANGE or ev.name.startswith(STEP_RANGE)
        if ev.device_type == DeviceType.CPU:
            if ev.name == BATCH_RANGE:
                batches.append((s, e))
            elif not ranged:
                host.append((s, e, ev.name))
        elif e > s and not ranged and not getattr(ev, "is_user_annotation", False):
            # a range's mirror on the device timeline spans its work: not work
            device.append((ev.name, s, e))
    return host, device, batches


def busy(device) -> float:
    """Seconds covered by at least one device interval."""
    return sum(e - s for s, e in _union([(s, e) for _, s, e in device]))


def idle_gaps(events) -> dict:
    """Pass 2: the device's idle seconds inside the batch ranges, by the
    host operation running at each gap's midpoint."""
    host, device, batches = _split(events)
    if not batches:
        raise ValueError("the trace holds no batch range")
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict = {}
    for w0, w1 in batches:
        # the device's clock is mapped onto the host's with some error:
        # intervals are clipped to the batch for the holes between them
        union = _union([(max(s, w0), min(e, w1)) for _, s, e in device if e > w0 and s < w1])
        edges = [w0] + [x for iv in union for x in iv] + [w1]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            mid = (g0 + g1) / 2
            i = bisect.bisect_right(starts, mid)
            name = "python"
            for j in range(i - 1, max(i - 1 - _NEAR, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            gaps[name] = gaps.get(name, 0.0) + (g1 - g0)
    return gaps


def _device_activity():
    import torch
    from torch.profiler import ProfilerActivity
    # a build without CUDA (the CPU tests) records host operations only
    return ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU


def traced(run_batch, active: int) -> Trace:
    """Trace ``active`` calls of ``run_batch(step)`` (steps 1..active)
    after one warm-up call (step 0), twice (see the module's docstring);
    each call ends with the device idle."""
    import time

    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile, schedule
    plain, walls = [], []
    for step in range(1, active + 1):
        t0 = time.perf_counter()
        run_batch(step)
        plain.append(time.perf_counter() - t0)
    with profile(activities=[_device_activity()],
                 schedule=schedule(wait=0, warmup=1, active=active, repeat=1)) as prof:
        for step in range(active + 1):
            t0 = time.perf_counter()
            run_batch(step)
            if step:
                walls.append(time.perf_counter() - t0)
            prof.step()
    _, device, _ = _split(prof.events())
    with profile(activities=sorted({ProfilerActivity.CPU, _device_activity()}, key=str),
                 schedule=schedule(wait=0, warmup=1, active=active, repeat=1)) as prof:
        for step in range(active + 1):
            with record_function(BATCH_RANGE):
                run_batch(step)
            prof.step()
    gaps = idle_gaps(prof.events())
    return Trace(window_s=sum(plain), busy_s=busy(device), traced_s=sum(walls), kernels=device,
                 gaps=gaps)
