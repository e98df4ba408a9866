"""The readers of the program's counters, the attribution of device work to
the program's spans, and the span probe, on the CPU."""
import json
import time
import types

import pytest
import torch
from conftest import ROOT

import probe_spans
from rangebench.harness import cell as cells
from rangebench.harness import counters, spec
from rangebench.harness.spans import (
    OUTSIDE, WALK_STAGES, Attribution, DeviceEvent, HostEvent, attribute, readings)

CPU = torch.device("cpu")
NEW = ("host_syncs_per_batch", "greedy_iters")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _reader(name):
    return spec.reader(name, ROOT / "rangebench")


def _ctx(busy=1.0, costs=None, trace=True):
    tr = types.SimpleNamespace(busy_s=busy) if trace else None
    cell = types.SimpleNamespace(settings={"trace_batches": 2})
    return types.SimpleNamespace(trace=tr, costs=costs or {}, cell=cell)


@pytest.mark.parametrize("name", NEW)
def test_rangebench_counter_readers(name):
    mod = _reader(name)
    assert mod.HOOK == "repro_torch.trace:count" and mod.OWNER == counters.OWNER
    full = {name: (700, 582)}
    assert mod.read(_ctx(costs=full)) == 291.0
    assert mod.read(_ctx(costs=full, trace=False)) is None      # no trace
    assert mod.read(_ctx(costs=full, busy=0.0)) is None         # no device work (a CPU run)
    assert mod.read(_ctx(costs={})) is None                     # no hook (no counter to read)
    other = "walk.beam_iters"
    assert mod.launch_cost((mod.COUNTER,), {}, None) == 1
    assert mod.launch_cost((mod.COUNTER, 3), {}, None) == 3
    assert mod.launch_cost((), {"name": mod.COUNTER, "n": 2}, None) == 2
    assert mod.launch_cost((other,), {}, None) == 0


@pytest.mark.parametrize("name", NEW)
def test_rangebench_counter_readers_without_the_counter(name, monkeypatch):
    """A program without ``repro_torch.trace``: no hook, nothing read, nothing raised."""
    monkeypatch.setattr(counters, "present", lambda: False)
    mod = _reader(name)
    assert not hasattr(mod, "HOOK") and not hasattr(mod, "OWNER")
    assert mod.read(_ctx()) is None


def test_rangebench_new_metrics_are_listed():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    cells_ = [w["name"] for w in BENCH["workloads"]]
    for name in NEW:
        assert per[name]["source"] == "program_counter" and per[name]["moves"] == "qps"
        assert per[name]["workloads"] == cells_


def test_rangebench_cost_pass_counts_what_a_batch_adds(tiny):
    """The hook on ``trace.count`` sees every addition of the cost pass's
    batches: the same as the counters gain over the same batches run alone."""
    from repro_torch import trace
    c = spec.load(tiny, "tiny-int8.mixed")
    setup = cells.build(c, 11, CPU, time.perf_counter())
    readers = {n: _reader(n) for n in NEW}
    costs = cells.count_costs(setup, range(1, 3), readers, CPU)
    before = trace.counters()
    for step in (1, 2):
        cells.answer(setup, step)
    after = trace.counters()
    for name, mod in readers.items():
        assert costs[name][1] == after[mod.COUNTER] - before.get(mod.COUNTER, 0) > 0
    assert not isinstance(trace.count, cells._Recorder)   # the hook is taken off again


# -- attribution of device work to spans ------------------------------------

def _made_trace():
    """Two batches on thread 1. Spans: range > (phase1 > step > merge,
    phase2); ops and runtime calls inside them; device work launched by
    each, one kernel overlapping another."""
    host = [
        HostEvent("rangebench.batch", 0.0, 10.0, 1, 0),
        HostEvent("range", 0.5, 9.5, 1, 1),
        HostEvent("range.phase1", 1.0, 5.0, 1, 2),
        HostEvent("walk.step", 1.5, 4.0, 1, 3),
        HostEvent("aten::add", 1.6, 1.7, 1, 4),
        HostEvent("walk.merge", 2.0, 3.0, 1, 5),
        HostEvent("aten::sort", 2.1, 2.2, 1, 6),
        HostEvent("cudaLaunchKernel", 2.15, 2.16, 1, 900),
        HostEvent("range.phase2", 6.0, 9.0, 1, 7),
        HostEvent("cudaLaunchKernel", 6.5, 6.6, 1, 901),
        HostEvent("aten::copy_", 9.7, 9.8, 1, 8),            # the harness's, outside any span
        HostEvent("rangebench.batch", 20.0, 30.0, 1, 0),
        HostEvent("range", 20.5, 29.5, 1, 9),
        HostEvent("range.phase1", 21.0, 29.0, 1, 10),
    ]
    device = [
        DeviceEvent("add_kernel", 4.0, 5.0, 500, 4),          # by aten::add in walk.step
        DeviceEvent("sort_kernel", 5.0, 7.0, 900, 6),         # by aten::sort in walk.merge
        DeviceEvent("expand_kernel", 6.0, 8.0, 901, 0),       # no op link: the runtime call's
        DeviceEvent("copy_kernel", 9.8, 9.9, 502, 8),         # outside every span
        DeviceEvent("ctypes_kernel", 22.0, 23.0, 503, 10),    # linked to the span itself
        DeviceEvent("lost_kernel", 24.0, 24.5, 504, 0),       # no link at all
        DeviceEvent("range.phase1", 21.0, 29.0, 505, 10),     # a span's mirror: not work
    ]
    names = {"range", "range.phase1", "range.phase2", "walk.step", "walk.merge"}
    return host, device, names


def test_rangebench_kernel_goes_to_its_launching_span():
    host, device, names = _made_trace()
    a = attribute(host, device, names)
    chains = {d.name: ch for d, (_, _, ch) in zip(device, a.intervals)}
    assert chains["add_kernel"] == ("walk.step", "range.phase1", "range")
    assert chains["sort_kernel"] == ("walk.merge", "walk.step", "range.phase1", "range")
    # launched in phase 2, running while phase 1's span was open on the host:
    # the link decides, not the device's timestamps
    assert chains["expand_kernel"] == ("range.phase2", "range")
    assert chains["copy_kernel"] == () and chains["lost_kernel"] == ()
    assert chains["ctypes_kernel"] == ("range.phase1", "range")
    assert len(a.intervals) == 6
    assert a.linked == {"operation": 4, "runtime": 1, "none": 1}
    assert a.batches == 2


def test_rangebench_nested_spans_do_not_count_twice():
    host, device, names = _made_trace()
    a = attribute(host, device, names)
    by = a.busy_by_span()
    # walk.step holds add (4-5) and, through walk.merge, sort (5-7): 3 s once
    assert by["walk.step"] == (3.0, 1.0)
    assert by["walk.merge"] == (2.0, 2.0)
    # phase 1: add, sort and the ctypes kernel; phase 2's expand overlaps sort
    assert by["range.phase1"] == (4.0, 1.0)
    assert by["range.phase2"] == (2.0, 2.0)
    # the three stages together: 4-8 and 22-23, a union, not 4 + 2
    assert a.busy_in(WALK_STAGES) == 5.0 == by["range"][0]
    assert by[OUTSIDE] == pytest.approx((0.6, 0.6))


def test_rangebench_idle_gaps_by_span():
    host, device, names = _made_trace()
    a = attribute(host, device, names)
    # batch 1 (0-10): busy 4-8 and 9.8-9.9; gaps 0-4 (mid 2: walk.merge),
    # 8-9.8 (mid 8.9: phase2), 9.9-10 (mid 9.95: outside); batch 2 (20-30):
    # busy 22-23 and 24-24.5; gaps 20-22 (mid 21: phase1), 23-24, 24.5-30
    # (mids 23.5, 27.25: phase1)
    assert a.idle == pytest.approx({"walk.merge": 4.0, "range.phase2": 1.8,
                                    OUTSIDE: 0.1, "range.phase1": 8.5})


def test_rangebench_readings_of_a_pass():
    summ = {"walk.step": (10, 30_000_000, 20_000_000)}
    counted = {"host_syncs": 30, "walk.greedy_iters": 8, "walk.beam_iters": 10}
    a = Attribution(intervals=[(0.0, 0.002, ("walk.merge", "walk.step", "range.phase1")),
                               (0.001, 0.003, ("range.phase2",)),
                               (0.004, 0.005, ("range.result",))],
                    idle={}, linked={}, batches=2)
    got = readings(summ, counted, a, 2)
    assert got == pytest.approx({"host_syncs_per_batch": 15.0, "greedy_iters": 4.0,
                                 "walk_host_us_per_iter": 3000.0,
                                 "walk_host_self_us_per_iter": 2000.0,
                                 "walk_device_ms": 1.5, "merge_device_ms": 1.0})


def test_rangebench_probe_on_a_throwaway_cell(tiny):
    out = probe_spans.probe(spec.load(tiny, "tiny-int8.mixed"), 123456789, CPU,
                            time.perf_counter(), repeat=2)
    assert out["bitwise"] and out["digest"][0] == out["digest"][1]
    m = out["repeats"][-1]
    per = out["counters_per_batch"]
    assert m["host_syncs_per_batch"] == per["host_syncs"] > per["walk.beam_iters"]
    assert m["greedy_iters"] == per["walk.greedy_iters"] > 0
    assert m["walk_host_us_per_iter"] >= m["walk_host_self_us_per_iter"] > 0
    assert len(out["repeats"]) == len(out["pass0_s"]) == len(out["pass_a_s"]) == 2
    assert len(out["busy_s"]) == len(out["attributed_busy_s"]) == 2
    assert min(out["pass0_s"] + out["pass_a_s"]) > 0
    assert out["spans_per_batch"] > 2 * per["walk.beam_iters"]
    json.dumps(out)
