"""The byte counts of hand-counted launches, and the trace's reduction."""
import types

import pytest
import torch
from torch.autograd import DeviceType

from rangebench.harness import costs, trace

PAD = 2**31 - 1


def test_rangebench_expand_cost_hand_counted():
    # N=10 rows, R=2; Q=2 lanes, E=2: lane 0 expands nodes 3 and 3 (one
    # distinct adjacency row), lane 1 nothing (dead lane: no query read)
    nbrs = torch.zeros(10, 2, dtype=torch.int32)
    frontier = torch.tensor([[3, 3], [-1, PAD]], dtype=torch.int32)
    queries = torch.zeros(2, 8)
    ids = torch.tensor([[5, 6, 5, PAD], [PAD, PAD, PAD, PAD]], dtype=torch.int32)
    n_bytes, flops = costs.expand_cost(ids, frontier, nbrs, queries, row_bytes=32)
    want = (2 * 32        # kept rows 5 and 6, once each
            + 1 * 2 * 4   # adjacency row of node 3
            + 4 * 4       # the frontier
            + 1 * 8 * 4   # the live lane's query
            + 8 * 8       # ids and distances out
            + 2 * 4)      # a count a lane
    assert n_bytes == want and flops == 3 * 8 * 3


def test_rangebench_rerank_cost_hand_counted():
    ids = torch.tensor([4, 4, 9], dtype=torch.int32)
    lanes = torch.tensor([0, 1, 1], dtype=torch.int32)
    assert costs.rerank_cost(ids, lanes, 16) == ((2 + 2) * 16 * 4 + 3 * 12, 3 * 16 * 3)


def test_rangebench_bound_takes_the_larger_term():
    assert costs.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert costs.bound_s(0, 67e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name,owner", [
    ("void (anonymous namespace)::expand_bulk_kernel<float>(float const*, int)", "expand"),
    ("void (anonymous namespace)::expand_int8_bulk_kernel(signed char const*)", "expand_int8"),
    ("rerank_fetch_regs_kernel(float const*, int const*)", "rerank_fetch"),
    ("gatherdist_int8_regs_kernel", "gatherdist_int8"),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
])
def test_rangebench_kernel_owner(name, owner):
    assert trace.kernel_owner(name, ("expand", "expand_int8", "gatherdist",
                                     "gatherdist_int8", "rerank_fetch")) == owner


def _ev(name, start_us, end_us, dev):
    return types.SimpleNamespace(name=name, device_type=dev,
                                 time_range=types.SimpleNamespace(start=start_us, end=end_us))


def test_rangebench_trace_union_and_gaps():
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    device = [
        _ev("expand_bulk_kernel<float>(", 0, 10, gpu),
        _ev("other_kernel(", 5, 20, gpu),       # overlaps: counts once
        _ev("expand_bulk_kernel<float>(", 60, 70, gpu),
    ]
    _, intervals, _ = trace._split(device)
    assert trace.busy(intervals) == pytest.approx(30e-6)     # [0, 20] and [60, 70]
    tr = trace.Trace(window_s=100e-6, busy_s=trace.busy(intervals), traced_s=150e-6,
                     kernels=intervals, gaps={})
    assert tr.owner_time("expand", ("expand",)) == (2, pytest.approx(20e-6))
    assert tr.top_ops()[0][0].startswith("expand_bulk_kernel")
    # gap [20, 60] at midpoint 40: aten::nonzero still runs (its sync ended
    # at 38); gap [70, 100]: between operations
    gaps = trace.idle_gaps(device + [
        _ev(trace.BATCH_RANGE, 0, 100, cpu),
        _ev("aten::nonzero", 10, 40, cpu),
        _ev("cudaStreamSynchronize", 12, 38, cpu),
    ])
    assert gaps == {"aten::nonzero": pytest.approx(40e-6), "python": pytest.approx(30e-6)}
    # two batch ranges: the time between them is not a gap
    gaps = trace.idle_gaps([_ev(trace.BATCH_RANGE, 0, 10, cpu), _ev(trace.BATCH_RANGE, 50, 60, cpu),
                            _ev("k(", 0, 10, gpu), _ev("k(", 50, 55, gpu)])
    assert gaps == {"python": pytest.approx(5e-6)}


def test_rangebench_roofline_reads_nothing_without_agreement():
    tr = trace.Trace(window_s=1.0, busy_s=0.5, traced_s=1.5, kernels=[("expand_k(", 0.0, 0.2)],
                     gaps={})
    ctx = types.SimpleNamespace(trace=tr, costs={"m": (1, 0.1)}, owners=("expand",))
    assert costs.roofline(ctx, "m", "expand") == pytest.approx(50.0)
    ctx.costs = {"m": (2, 0.1)}                 # the counting run saw another launch count
    assert costs.roofline(ctx, "m", "expand") is None
    ctx.trace = None
    assert costs.roofline(ctx, "m", "expand") is None
