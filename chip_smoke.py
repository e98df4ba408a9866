#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

    python3 chip_smoke.py                 # full size: N=1M, d=128, Q=4096
    python3 chip_smoke.py --n 100000      # a shorter rehearsal
    python3 chip_smoke.py --result-cap 4096   # a larger result buffer, and
                                              # the two-tower AP probes

Phases, each printed as it ends:
  1. build the CUDA kernels from the sources in the checkout (nvcc, sm_90a,
     one process per source, all started together); print the build time
     and the card's name and power limit;
  2. a bigann-like corpus from a seed and its exact k-NN graph (R=32), and
     its int8 quantization (one pass on the card);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (time, bound, plain version's time): expand
     and gatherdist (f32/bf16), expand-int8 and gatherdist-int8 in both
     arithmetic forms (int32 dots equal; the two kernels bit for bit on
     shared candidates, on every route of each), rerank_fetch at P in {1,
     17, 4096, 16384, 24576, 32768, 65536}; expand and expand-int8 on the
     route their plan takes (bulk) and on the warp route, bit for bit
     equal, each timed; gatherdist-int8 at random start points and at the
     main path's 4 shared ones, and rerank_fetch, on both routes (regs and
     the first kernel, warp), beside an empty kernel on the planned grid
     (the launch floor);
  4. the radius, chosen the paper's way (sweep + select_radius) on a
     256-query sample, for half the queries to answer empty;
  5. the f32 main path: ``RangeSearchEngine.range(compacted=True)`` on all
     queries in greedy, beam and doubling modes (QPS, AP against
     ``exact_range_search``, match histogram, launches of each kernel,
     expand's routes, all bulk);
  6. the int8 main path: ``from_graph(corpus_dtype="int8")`` on the same
     graph and radius, greedy/beam/doubling in the f32-query form and
     greedy in the int8-query form (QPS, AP, AP against f32, mean n_rerank,
     band size P, launches and routes, each kernel's redesigned route
     asserted; no false positive); rerank_fetch at the band the greedy run
     produced on each route (regs, warp), warm and with L2 flushed before
     each launch; the expand launches of the greedy
     f32, int8 f32-query and int8 int8-query batches (kept on their
     warm-up runs) replayed in one CUDA graph on each route ([served]:
     sum, mean a launch, count, bound; every launch bit for bit equal on
     the two routes);
  7. the guard-band contract on 256 queries: the post-rerank set equals the
     rerank-disabled set filtered by the exact distances;
  8. the kernel path against the plain path through the same engines on a
     256-query subset (AP within 0.01), f32 and int8;
 11. [tier]: ``from_graph(corpus_dtype="int8", tier=True)`` on the k-NN
     graph (raw rows in pinned host memory), greedy int8, two calls (cold,
     warm) at the default cache (n/8 rows) and at a third of the band's
     distinct rows (evicting): ids, dists, count and n_rerank bit for bit
     the resident int8 engine's in every call, the same rerank_fetch route;
     the counters (pairs, rows, hits, misses, MB fetched, evictions), the
     device bytes against the resident corpus's, QPS against resident;
 12. [vamana]: ``build_vamana`` on the card (R=32, beam 64, alpha 1.2,
     batches up to 1024; the reference's serve CLI settings): build time
     and its split (search, prune, reverse edges), expand and gatherdist
     launches and routes, every row checked (no id out of range, no self
     loop, no duplicate), degrees and the share reachable from the medoid;
     greedy f32 and int8 on it beside the k-NN graph's QPS and AP, the
     kernel path against the plain path (AP within 0.01), the guard band;
 13. [filtered]: benchmarks/run.py's filtered workload on the Vamana engine
     (16 labels, 1-2 a point; 128 queries alternating one-label AND and
     four-label OR; the radius of ~128 mean matches): unfiltered and
     filtered QPS and AP (against the post-filtered oracle; the gap <=
     0.01), then the selective lanes on the fallback scan (every lane
     n_visited == 0, answers equal to the post-filtered oracle as sets up to
     pairs within 1e-5 of r), its QPS against the walk's, and its
     rerank_fetch launch and route;
 14. [serve]: the serving layer (``RangeServer``) on the Vamana engine,
     with the reference serve CLI's settings (max_batch 128, 32 lanes, 8
     rounds a slice, the effort regressor fitted on the card on 256
     calibration requests with their exact counts): lockstep, f32 and
     int8, on the 4,096 queries at r, every response equal to its lane of
     ``engine.range`` (f32: the distances' bits too), requests/s beside
     engine.range's QPS and exact p50/p99; benchmarks/run.py's tail
     workload (1,024 requests, every 16th at the radius of ~512 mean
     matches, the rest at ~4) in lockstep and continuously, each after a
     warm-up pass, f32 and int8: continuous equal to lockstep per request,
     AP of both, point p50/p99, heavy p99, the point-p99 ratio, the pool
     counters; a 256-request continuous pass on the plain path (AP within
     0.01 of the kernel path); every path kernel launched through the
     server (``serve_launches`` in the kernels line);
  9. [two_tower], run right after the build so its 43 GB tables find the
     card empty: the two-tower-retrieval model at full width (16 + 16
     fields, vocab 10,485,760, d_embed 64, towers 1024-1024-512-256, both
     from seeds), 1M items embedded by the item tower (freed before the
     user tower is built), 512 user requests (serve_p99) and 1
     (retrieval_cand); the radius the paper's way at ip; brute-force
     serving (user tower + rangescan, k=256) and the graph engine on the
     same corpus (exact k-NN graph at ip, greedy) with QPS, AP and
     launches (expand's routes asserted bulk); expand and gatherdist
     against their plain versions at that path's shapes (ip, d=256), and
     the graph engine's kernel path equal
     to its plain path on every lane; rangescan against its plain version
     at k=128 and k=256 on the 512 requests, on 64 and on 1, every lane,
     excusing only pairs within 1e-5 of the radius or of each other (f32
     rounding of a reordered dot of two unit vectors at d=256 is ~1e-6),
     with the route of each call (the served batch asserted on wgmma);
     the kernel's time and TFLOP/s against both bounds (the f32 pipes,
     and three TF32 products on the tensor cores), the SIMT route, the
     plain version and the product alone (one torch.matmul); with
     --profile, a trace of the brute-force batch (tower, scan, merge);
 10. [lm], right after [two_tower] (its 54 GB of weights need the card
     too): gemma3-27b at full width and depth (62 layers, 52 local with a
     1024 window and 10 global, 32 heads over 16 kv heads, dh 128, vocab
     262,144) in bf16 from seed 0; 4 prompts of 4,096 tokens from the
     synthetic LM stream prefilled (cache of 4,128) and 32 greedy decode
     steps, with flashattn's launches counted (62 a prefill, 62 a step)
     and its routes (all 62 prefill calls on wgmma, every step's on
     decode_split); the kernel path against the plain path
     (use_kernels=False) on prompt 0, full depth in bf16 (relative L2 of
     the last-token logits <= 5e-2 on every step) and depth 6 in f32
     (<= 1e-4, argmax equal); flashattn against its plain version at the
     JAX tests' shapes and on the inputs the path gave one local and one
     global layer at prefill and at a decode step, with its route (and
     split count), its time against the bound (TFLOP/s or GB/s and the
     share of the bound), the plain version and one
     scaled_dot_product_attention call (and the ratio to it).

The search configuration is the repo's single-shard deployment,
``EngineDeployConfig()`` (src/repro_torch/configs/range_engine.py, the
reference's): 1M points per shard, d=128, R=32, l2, beam=64,
visit_cap=256, E=4, greedy, result_cap=1024, frontier_rounds=2048,
4096-query batches; f32 and its production int8 setting; the other modes
and the filtered workload through ``overrides()``. The two-tower phase serves the configuration of
src/repro_torch/configs/two_tower_retrieval.py with the search settings of
examples/two_tower_range.py (k=256; beam=32, visit_cap=128, greedy,
result_cap=512); the LM phase serves src/repro_torch/configs/gemma3_27b.py.
Any failure exits non-zero. The last line is the device JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_QUERIES = 4096            # the deployment's search_4k batch
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
INT8_OPS = 1979e12          # H100 SXM int8 (the table's rate for the type)
BF16_FLOPS = 989e12         # H100 SXM bf16, dense tensor cores
TF32_FLOPS = 495e12         # H100 SXM tf32, dense tensor cores (3xTF32: three products)
DIST_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),  # sum order differs
            "bfloat16": dict(rtol=1e-2, atol=1e-5)}
RANGESCAN_TOL = 1e-5        # unit vectors, d=256: reordered f32 dots differ ~1e-6
TT_CHUNK = 65_536           # items a tower embeds at once
LM_PROMPTS, LM_PROMPT_LEN, LM_STEPS = 4, 4096, 32
LM_PARAMS = 27_009_002_240  # gemma3-27b's parameters (sum of the table shapes)
LM_MAX_LEN = LM_PROMPT_LEN + LM_STEPS
LM_BF16_REL = 5e-2          # kernel vs plain path, bf16, full depth: rel. L2 of logits
LM_F32_REL = 1e-4           # the same in f32 at depth 6
FLASH_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),    # sum order, q scaled first
             "bfloat16": dict(rtol=1e-2, atol=1e-2)}   # one bf16 ulp of the output
FLASH_CASES = [   # tests/test_kernels.py's five: b, hq, hkv, sq, skv, dh, causal,
    (2, 4, 2, 64, 64, 32, True, 0, 0.0, 0),        # window, softcap, q_offset
    (1, 8, 2, 37, 37, 16, True, 0, 50.0, 0),
    (1, 4, 4, 16, 128, 32, True, 64, 0.0, 112),
    (2, 2, 1, 33, 65, 64, False, 0, 0.0, 0),
    (1, 6, 3, 128, 128, 64, True, 32, 30.0, 0),
]
PORT_KERNELS = ("expand", "gatherdist", "rerank_fetch", "rangescan", "flash")
GRAPH_CALLS = 20            # calls a graph when timing kernels of a few us
TRACE_PAUSE_S = 0.05        # host pause on each side of the step into the traced run
ENTRY_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
              "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, repeats: int = 5, graph: bool = True,
            calls: int = 1) -> float:
    """Device time of one call: ``fn`` is captured ``calls`` times in one
    CUDA graph and the graph replayed ``reps`` times between two CUDA
    events, so the host's launch overhead is not counted; the median over
    ``repeats`` such runs. A kernel of a few microseconds takes ``calls``
    > 1: one replay a call would time the host's replay rate (the
    ``[kernel] gatherdist-int8 launch floor`` line times an empty kernel
    both ways). With
    ``graph=False`` the calls themselves run between the events (for
    plain versions whose launches are few against their device time)."""
    import torch
    if not graph:
        fn()
        times = []
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return float(np.median(times))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (reps * calls))
    return float(np.median(times))


FLUSH_BYTES = 128 * 2**20   # more than the H100's 50 MB L2


def cold_ms(fn, flush, reps: int = 20) -> float:
    """Device time of one call that finds L2 holding none of its inputs:
    ``fn`` is captured once in a CUDA graph, and each of ``reps`` replays
    runs between two CUDA events right after a write of ``flush`` (a
    tensor of FLUSH_BYTES); the median. The write keeps the card busy while
    the host enqueues the events and the replay, so the host's launch
    overhead is not counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps):
        flush.fill_(1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: float, ops: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, ops / rate
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def check_close(name, got, want, tol) -> float:
    import torch
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{name}: +inf pattern differs from the plain version")
    if not torch.allclose(got[fin], want[fin], **tol):
        raise AssertionError(f"{name}: distances differ beyond {tol}")
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def make_frontier(n, qn, e, gen, dev):
    import torch
    from repro_torch.utils import INVALID_ID
    frontier = torch.randint(0, n, (qn, e), generator=gen, device=dev,
                             dtype=torch.int32)
    frontier[::8, 3] = INVALID_ID            # exhausted frontier slots
    frontier[::16, 1] = frontier[::16, 0]    # duplicate frontier nodes
    return frontier


def same_bits(a, b) -> bool:
    """Whether two tuples of tensors hold the same bits."""
    import torch
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a, b))


def expand_bytes(ids, frontier, nbrs, queries, row_bytes: int) -> int:
    """Bytes an expansion must move: each distinct surviving row once, each
    distinct frontier node's adjacency row once, the frontier, the queries
    and the outputs (ids, distances, n_dist)."""
    import torch
    from repro_torch.utils import INVALID_ID
    n, r = nbrs.shape
    kept = ids[ids != INVALID_ID]
    f_ok = frontier[(frontier >= 0) & (frontier < n)]
    return (torch.unique(kept).numel() * row_bytes
            + torch.unique(f_ok).numel() * r * 4 + frontier.numel() * 4
            + queries.numel() * 4 + ids.numel() * 8 + frontier.shape[0] * 4)


def kernel_checks(points, nbrs, queries, gen, dtypes=("float32", "bfloat16"),
                  metrics=("l2", "ip"), widths=(4, 32), tag=""):
    """Each f32/bf16 kernel against its plain version at the main path's
    shapes (E=4, SearchConfig's default; gatherdist at S in ``widths``).
    Returns the JSON entries of the f32 l2 configuration the main path
    runs, where it is among those checked."""
    import torch
    from repro_torch.kernels.expand import expand_cuda, expand_frontier_ref
    from repro_torch.kernels.gatherdist import gatherdist_cuda, gatherdist_ref
    from repro_torch.utils import INVALID_ID
    n, d = points.shape
    r = nbrs.shape[1]
    qn, e = queries.shape[0], 4
    dev = points.device
    frontier = make_frontier(n, qn, e, gen, dev)
    entries = {}
    for dtype in dtypes:
        pts = points.to(getattr(torch, dtype)).contiguous()
        for metric in metrics:
            args = (pts, nbrs, frontier, queries)
            route = kernel_route(expand_cuda, lambda: expand_cuda(*args, metric=metric))
            ids, dd, nd = expand_cuda(*args, metric=metric)
            warp = expand_cuda(*args, metric=metric, route="warp")
            rids, rd, rnd = expand_frontier_ref(*args, metric=metric)
            torch.cuda.synchronize()
            if not (torch.equal(ids, rids) and torch.equal(nd, rnd)):
                raise AssertionError(f"expand {dtype} {metric}: ids/n_dist differ")
            err = check_close(f"expand {dtype} {metric}", dd, rd, DIST_TOL[dtype])
            if not same_bits((ids, dd, nd), warp):
                raise AssertionError(f"expand {dtype} {metric}: the {route} and warp "
                                     "routes differ")
            ms = time_ms(lambda: expand_cuda(*args, metric=metric))
            warp_ms = time_ms(lambda: expand_cuda(*args, metric=metric, route="warp"))
            plain = time_ms(lambda: expand_frontier_ref(*args, metric=metric))
            kept = ids[ids != INVALID_ID]
            n_bytes = expand_bytes(ids, frontier, nbrs, queries,
                                   d * pts.element_size())
            flops = kept.numel() * (3 if metric == "l2" else 2) * d
            b_ms, b_by = bound_ms(n_bytes, flops)
            log(f"[kernel] expand{tag} {dtype} {metric} Q={qn} E={e} R={r} d={d}: "
                f"ids/n_dist equal, max_abs_err={err:.3g}, route {route}: ms={ms:.4f} "
                f"({b_ms / ms:.1%} of the bound), warp route ms={warp_ms:.4f} "
                f"({b_ms / warp_ms:.1%}), bitwise equal; plain_ms={plain:.4f}, "
                f"bound_ms={b_ms:.4f} ({b_by}, {n_bytes / 1e6:.1f} MB), gathered "
                f"rows={kept.numel()}")
            if (dtype, metric) == ("float32", "l2"):
                entries["expand"] = dict(
                    name="expand", route="cuda",
                    source="src/repro_torch/kernels/expand/csrc/expand.cu",
                    replaces="src/repro/kernels/expand/kernel.py:49",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None, expand_route=route,
                    warp_ms=warp_ms)
        for s in widths:
            ids = torch.randint(0, n, (qn, s), generator=gen, device=dev,
                                dtype=torch.int32)
            ids[::5, -1] = INVALID_ID
            for metric in metrics:
                args = (pts, ids, queries)
                got = gatherdist_cuda(*args, metric=metric)
                want = gatherdist_ref(*args, metric=metric)
                torch.cuda.synchronize()
                err = check_close(f"gatherdist {dtype} {metric} S={s}", got,
                                  want, DIST_TOL[dtype])
                ms = time_ms(lambda: gatherdist_cuda(*args, metric=metric), calls=GRAPH_CALLS)
                plain = time_ms(lambda: gatherdist_ref(*args, metric=metric))
                ok = ids[(ids >= 0) & (ids < n)]
                n_bytes = (torch.unique(ok).numel() * d * pts.element_size()
                           + ids.numel() * 8 + queries.numel() * 4)
                flops = ok.numel() * (3 if metric == "l2" else 2) * d
                b_ms, b_by = bound_ms(n_bytes, flops)
                log(f"[kernel] gatherdist{tag} {dtype} {metric} Q={qn} S={s} d={d}: "
                    f"max_abs_err={err:.3g}, ms={ms:.4f}, plain_ms={plain:.4f}, "
                    f"bound_ms={b_ms:.4f} ({b_by})")
                if (dtype, metric, s) == ("float32", "l2", 4):
                    entries["gatherdist"] = dict(
                        name="gatherdist", route="cuda",
                        source="src/repro_torch/kernels/gatherdist/csrc/gatherdist.cu",
                        replaces="src/repro/kernels/gatherdist/kernel.py:32",
                        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    return entries


def int8_kernel_checks(qc, nbrs, queries, gen):
    """expand-int8 and gatherdist-int8 in both forms against their plain
    versions at the main path's shapes (int32 dots equal in the int8-query
    form), and against each other bit for bit on the candidates they share,
    every route of each; gatherdist-int8 at random start points and at the
    main path's 4 shared ones, on its planned route and the first kernel
    (bit for bit equal), beside an empty kernel on its grid; rerank_fetch
    at P in {1, 17, 4096, 16384, 24576, 32768, 65536} on both routes (regs
    and warp, which the plan takes below REGS_MIN_PAIRS), on random lanes
    and lane-major ones (the band's order, timed).
    Returns the JSON entries of the form the main path runs by default
    (f32-query, l2; ``form`` says so), each with the int8-query form's
    times beside it."""
    import torch
    from repro_torch.kernels._launch import empty_launch
    from repro_torch.kernels.expand import expand_frontier_int8_ref, expand_int8_cuda
    from repro_torch.kernels.gatherdist import gatherdist_int8_cuda, gatherdist_int8_ref
    from repro_torch.kernels.rerank_fetch import fetch_rerank_pairs_ref, rerank_fetch_cuda
    from repro_torch.utils import INVALID_ID
    gather_ops = sys.modules["repro_torch.kernels.gatherdist.ops"]
    n, d = qc.shape
    r = nbrs.shape[1]
    qn, e = queries.shape[0], 4
    dev = qc.device
    frontier = make_frontier(n, qn, e, gen, dev)
    starts = torch.randint(0, n, (qn, 4), generator=gen, device=dev,
                           dtype=torch.int32)
    starts[::5, -1] = INVALID_ID
    # the main path's start points: engine.start_ids (S,) expanded to (Q, S)
    # by init_state, made contiguous by gather_dist
    shared = torch.randint(0, n, (4,), generator=gen, device=dev,
                           dtype=torch.int32).expand(qn, -1).contiguous()
    gp = gather_ops.plan(qn, d)
    def empty():
        empty_launch(gp.blocks, gp.threads, dev)

    floor = time_ms(empty, calls=GRAPH_CALLS)
    log(f"[kernel] gatherdist-int8 launch floor: the empty kernel on its grid "
        f"({gp.blocks} blocks of {gp.threads} threads) ms={floor:.4f} at "
        f"{GRAPH_CALLS} launches a graph, {time_ms(empty):.4f} at one a graph "
        f"(the host's replay rate)")
    tol = DIST_TOL["float32"]
    entries = {}
    for quant in (False, True):
        form = "int8-query" if quant else "f32-query"
        pre = "int8_query_" if quant else ""
        for metric in ("l2", "ip"):
            kw = dict(metric=metric, quantize_query=quant)
            args = (qc.codes, qc.meta, nbrs, frontier, queries)
            route = kernel_route(expand_int8_cuda, lambda: expand_int8_cuda(*args, **kw))
            got = expand_int8_cuda(*args, **kw, return_dots=quant)
            warp = expand_int8_cuda(*args, **kw, return_dots=quant, route="warp")
            want = expand_frontier_int8_ref(qc, nbrs, frontier, queries, **kw,
                                            return_dots=quant)
            torch.cuda.synchronize()
            ids, dd, nd = got[:3]
            if not (torch.equal(ids, want[0]) and torch.equal(nd, want[2])):
                raise AssertionError(f"expand-int8 {form} {metric}: ids/n_dist differ")
            if quant and not torch.equal(got[3], want[3]):
                raise AssertionError(f"expand-int8 {form} {metric}: int32 dots differ")
            err = check_close(f"expand-int8 {form} {metric}", dd, want[1], tol)
            if not same_bits(got, warp):
                raise AssertionError(f"expand-int8 {form} {metric}: the {route} and "
                                     "warp routes differ")
            # the two int8 kernels on the candidates they share: same bits,
            # on each of gatherdist-int8's routes
            keep = ids != INVALID_ID
            for g_route in (None, "warp"):
                g = gatherdist_int8_cuda(qc.codes, qc.meta, ids, queries, **kw,
                                         return_dots=quant, route=g_route)
                torch.cuda.synchronize()
                gd = g[0] if quant else g
                if not torch.equal(gd[keep].view(torch.int32), dd[keep].view(torch.int32)):
                    raise AssertionError(f"{form} {metric}: gatherdist-int8 ({g_route or 'planned'} "
                                         "route) and expand-int8 differ on shared candidates")
                if quant and not torch.equal(g[1][keep], got[3][keep]):
                    raise AssertionError(f"{form} {metric}: the two kernels' dots differ")
            ms = time_ms(lambda: expand_int8_cuda(*args, **kw))
            warp_ms = time_ms(lambda: expand_int8_cuda(*args, **kw, route="warp"))
            plain = time_ms(lambda: expand_frontier_int8_ref(
                qc, nbrs, frontier, queries, **kw))
            n_kept = int(keep.sum())
            n_bytes = expand_bytes(ids, frontier, nbrs, queries, d + 12)
            ops = n_kept * d * (2 if quant else (4 if metric == "l2" else 3))
            b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS if quant else F32_FLOPS)
            log(f"[kernel] expand-int8 {form} {metric} Q={qn} E={e} R={r} d={d}: "
                f"ids/n_dist equal{', dots equal' if quant else ''}, "
                f"max_abs_err={err:.3g}, route {route}: ms={ms:.4f} ({b_ms / ms:.1%} "
                f"of the bound), warp route ms={warp_ms:.4f} ({b_ms / warp_ms:.1%}), "
                f"bitwise equal; plain_ms={plain:.4f}, bound_ms={b_ms:.4f} ({b_by}, "
                f"{n_bytes / 1e6:.1f} MB), gathered rows={n_kept}; gatherdist-int8 "
                f"on the same {n_kept} candidates, both routes: bitwise equal")
            if (quant, metric) == (False, "l2"):
                entries["expand_int8"] = dict(
                    name="expand_int8", route="cuda",
                    source="src/repro_torch/kernels/expand/csrc/expand_int8.cu",
                    replaces="src/repro/kernels/expand/kernel.py:118",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None, form=form, expand_route=route,
                    warp_ms=warp_ms)
            elif metric == "l2":
                entries["expand_int8"].update(int8_query_ms=ms,
                                              int8_query_warp_ms=warp_ms)
            # gatherdist-int8 at the start points' shape (S=4): random starts
            # (the table's shape) and the main path's 4 shared starts
            gather = {}
            for shape, sids in (("random", starts), ("shared", shared)):
                sargs = (qc.codes, qc.meta, sids, queries)
                g_route = kernel_route(gatherdist_int8_cuda,
                                       lambda: gatherdist_int8_cuda(*sargs, **kw))
                got = gatherdist_int8_cuda(*sargs, **kw, return_dots=quant)
                old = gatherdist_int8_cuda(*sargs, **kw, return_dots=quant, route="warp")
                want = gatherdist_int8_ref(qc, sids, queries, **kw, return_dots=quant)
                torch.cuda.synchronize()
                got, old, want = [x if quant else (x,) for x in (got, old, want)]
                if quant and not torch.equal(got[1], want[1]):
                    raise AssertionError(f"gatherdist-int8 {form} {metric}: dots differ")
                if not same_bits(got, old):
                    raise AssertionError(f"gatherdist-int8 {form} {metric} {shape}: the "
                                         f"{g_route} and warp routes differ")
                err = check_close(f"gatherdist-int8 {form} {metric} {shape}",
                                  got[0], want[0], tol)
                ms = time_ms(lambda: gatherdist_int8_cuda(*sargs, **kw), calls=GRAPH_CALLS)
                old_ms = ms if g_route == "warp" else time_ms(
                    lambda: gatherdist_int8_cuda(*sargs, **kw, route="warp"),
                    calls=GRAPH_CALLS)
                plain = time_ms(lambda: gatherdist_int8_ref(qc, sids, queries, **kw))
                ok = sids[(sids >= 0) & (sids < n)]
                n_bytes = (torch.unique(ok).numel() * (d + 12) + sids.numel() * 8
                           + queries.numel() * 4)
                ops = ok.numel() * d * (2 if quant else (4 if metric == "l2" else 3))
                b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS if quant else F32_FLOPS)
                gather[shape] = dict(err=err, ms=ms, old_ms=old_ms, plain=plain,
                                     b_ms=b_ms, b_by=b_by, route=g_route)
                log(f"[kernel] gatherdist-int8 {form} {metric} Q={qn} S=4 d={d}, {shape} "
                    f"starts ({torch.unique(ok).numel()} distinct rows): "
                    f"{'dots equal, ' if quant else ''}max_abs_err={err:.3g}, route "
                    f"{g_route}: ms={ms:.4f} ({b_ms / ms:.1%} of the bound), "
                    f"{'planned' if g_route == 'warp' else f'warp route ms={old_ms:.4f}'}"
                    f", bitwise equal; floor {floor:.4f}, "
                    f"plain_ms={plain:.4f}, bound_ms={b_ms:.4f} ({b_by}, "
                    f"{n_bytes / 1e6:.2f} MB)")
            if metric != "l2":
                continue
            g, m = gather["random"], gather["shared"]
            if not quant:
                entries["gatherdist_int8"] = dict(
                    name="gatherdist_int8", route="cuda",
                    source="src/repro_torch/kernels/gatherdist/csrc/gatherdist_int8.cu",
                    replaces="src/repro/kernels/gatherdist/kernel.py:50",
                    max_abs_err=max(g["err"], m["err"]), ms=g["ms"], plain_ms=g["plain"],
                    bound_ms=g["b_ms"], bound_by=g["b_by"], library_ms=None, form=form,
                    gather_route=g["route"], floor_ms=floor)
            entries["gatherdist_int8"].update({
                f"{pre}ms": g["ms"], f"{pre}main_shape_ms": m["ms"],
                f"{pre}main_shape_bound_ms": m["b_ms"]})
            if g["route"] != "warp":
                entries["gatherdist_int8"].update({
                    f"{pre}old_route_ms": g["old_ms"],
                    f"{pre}main_shape_old_route_ms": m["old_ms"]})
            else:
                entries["gatherdist_int8"][f"{pre}gather_route"] = "warp"
    raw = qc.raw
    for p in (1, 17, 4096, 16384, 24576, 32768, 65536):
        ids = torch.randint(0, n, (p,), generator=gen, device=dev, dtype=torch.int32)
        lanes = torch.randint(0, qn, (p,), generator=gen, device=dev,
                              dtype=torch.int32)
        major = torch.sort(lanes).values     # lane-major, as the band arrives
        for metric in ("l2", "ip"):
            f_route = kernel_route(rerank_fetch_cuda, lambda: rerank_fetch_cuda(
                raw, queries, ids, major, metric=metric))
            errs, times = {}, {}
            for order, ln in (("random", lanes), ("lane-major", major)):
                fargs = (raw, queries, ids, ln)
                want = fetch_rerank_pairs_ref(*fargs, metric)
                for route in ("regs", "warp"):
                    got = rerank_fetch_cuda(*fargs, metric=metric, route=route)
                    torch.cuda.synchronize()
                    errs[route] = max(errs.get(route, 0.0), check_close(
                        f"rerank_fetch P={p} {metric} {order} {route}", got, want, tol))
            for route in ("regs", "warp"):
                times[route] = time_ms(lambda: rerank_fetch_cuda(
                    raw, queries, ids, major, metric=metric, route=route),
                    calls=GRAPH_CALLS)
            log(f"[kernel] rerank_fetch {metric} P={p} d={d} (random and lane-major "
                f"lanes; times lane-major): planned route {f_route}; regs "
                f"max_abs_err={errs['regs']:.3g}, ms={times['regs']:.4f}; warp "
                f"max_abs_err={errs['warp']:.3g}, ms={times['warp']:.4f}")
    return entries


def rerank_at_band(eng_q, queries, r, cfg, launches: int):
    """rerank_fetch against its plain version on the very pairs one int8
    main-path batch sends it: the band, taken from the rerank-disabled
    result as the result stage takes it. Each route (the planned one and
    the other) within tolerance and timed warm (graph replays: the rows sit
    in L2) and cold (L2 flushed before each launch, in turns), beside an
    empty kernel on the planned grid.
    Returns its JSON entry."""
    import torch
    from repro_torch.core import upper_bound_dists
    from repro_torch.kernels._launch import empty_launch
    from repro_torch.kernels.rerank_fetch import fetch_rerank_pairs_ref, rerank_fetch_cuda
    from repro_torch.utils import INVALID_ID
    fetch_ops = sys.modules["repro_torch.kernels.rerank_fetch.ops"]
    qc = eng_q.points
    pre = eng_q.range(queries, r, cfg=dataclasses.replace(cfg, rerank=False))
    valid = pre.ids != INVALID_ID
    ub = upper_bound_dists(qc, torch.where(valid, pre.ids, 0), pre.dists,
                           queries, "l2")
    lanes, slots = torch.nonzero(valid & (ub > r), as_tuple=True)
    ids = pre.ids[lanes, slots].contiguous()
    lanes = lanes.to(torch.int32).contiguous()
    p = ids.numel()
    if p == 0:
        raise AssertionError("the greedy int8 batch has an empty band")
    args = (qc.raw, queries, ids, lanes)
    route = kernel_route(rerank_fetch_cuda, lambda: rerank_fetch_cuda(*args))
    routes = tuple(dict.fromkeys((route, "regs", "warp")))
    want = fetch_rerank_pairs_ref(*args)
    errs = {}
    for rt in routes:
        got = rerank_fetch_cuda(*args, route=rt)
        torch.cuda.synchronize()
        errs[rt] = check_close(f"rerank_fetch at the band, route {rt}", got, want,
                               DIST_TOL["float32"])
    warm = {rt: time_ms(lambda: rerank_fetch_cuda(*args, route=rt)) for rt in routes}
    flush = torch.empty(FLUSH_BYTES // 4, device=qc.raw.device)
    cold = dict.fromkeys(routes, 0.0)
    for rt in routes + routes[::-1]:     # in turns: a, b, b, a
        cold[rt] += cold_ms(lambda: rerank_fetch_cuda(*args, route=rt), flush) / 2
    del flush
    blocks, threads = fetch_ops.launch_grid(p, qc.shape[1], route, qc.raw.device)
    floor = time_ms(lambda: empty_launch(blocks, threads, qc.raw.device),
                    calls=GRAPH_CALLS)
    plain = time_ms(lambda: fetch_rerank_pairs_ref(*args))
    d = qc.shape[1]
    n_rows = torch.unique(ids).numel()
    n_bytes = (n_rows + torch.unique(lanes).numel()) * d * 4 + p * 12
    b_ms, b_by = bound_ms(n_bytes, p * d * 3)
    runs = torch.unique_consecutive(lanes).numel()
    log(f"[kernel] rerank_fetch l2 at the greedy band P={p} ({n_rows} distinct rows, "
        f"{runs} runs of one lane) d={d}: route {route}: max_abs_err={errs[route]:.3g}, "
        f"ms={warm[route]:.4f} ({b_ms / warm[route]:.1%} of the bound), cold "
        f"{cold[route]:.4f} ({b_ms / cold[route]:.1%}; L2 flushed before each "
        f"launch); warp route ms={warm['warp']:.4f}, cold {cold['warp']:.4f}; "
        f"floor {floor:.4f} ({blocks} blocks of {threads} threads); plain_ms={plain:.4f}, "
        f"bound_ms={b_ms:.4f} ({b_by}); every pair's row read once: "
        f"{p * d * 4 / 1e6:.1f} MB, {p * d * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return dict(name="rerank_fetch", route="cuda",
                source="src/repro_torch/kernels/rerank_fetch/csrc/rerank_fetch.cu",
                replaces="src/repro/kernels/rerank_fetch/kernel.py:31",
                launches=launches, max_abs_err=errs[route], ms=warm[route],
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                fetch_route=route, old_route_ms=warm["warp"], floor_ms=floor,
                cold_ms=cold[route], old_route_cold_ms=cold["warp"])


def trace_launches(rows, names) -> dict:
    """Launches of each of the port's kernels in a trace, by wrapper name
    (``names``): a kernel belongs to the longest name its function's name
    begins with (``gatherdist_int8_regs_kernel`` to ``gatherdist_int8``,
    ``gatherdist_kernel`` to ``gatherdist``)."""
    every = set(names) | set(PORT_KERNELS) | {"expand_int8", "gatherdist_int8"}
    found = dict.fromkeys(names, 0)
    for e in rows:
        m = re.search(r"::(\w+)[<(]", e.key) or re.match(r"(\w+)", e.key)
        fname = m.group(1) if m else ""
        owner = max((n for n in every if fname.startswith(n + "_")), key=len,
                    default=None)
        if owner in found:
            found[owner] += e.count
    return found


def profile_run(fn, wall_s: float, name: str, kernels=None) -> None:
    """Device time by kernel over one traced run of ``fn``, and the device's
    busy share of ``wall_s``, the untraced run's wall time. ``fn`` runs
    twice: once while the tracer warms up, then traced, with a pause of
    TRACE_PAUSE_S on each side of the step between them. A kernel that runs
    right at the start of a trace (the search's first, gatherdist) was
    missing from some traces on an H100: with no warm-up in 6 of 7 traced
    modes, with the warm-up alone in 1 of 8; with the pause after the step
    alone, the warm-up's last kernels (3 expand-int8 launches and its
    rerank_fetch) landed in the traced window once. With ``kernels``
    (wrapper name to wrapper), the traced run's launch counts must equal
    the trace's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAUSE_S)
        prof.step()
        for k in (kernels or {}).values():
            k.launches = 0
        time.sleep(TRACE_PAUSE_S)
        fn()
        torch.cuda.synchronize()
        prof.step()
    # kernel rows only: the CPU-side op rows carry their kernels' time too,
    # and the schedule's ProfilerStep* row spans the whole step
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    if not rows:
        raise AssertionError(f"{name}: the profiler recorded no device time")
    total_us = sum(e.self_device_time_total for e in rows)
    log(f"[profile] {name}: device busy {total_us / 1e3:.2f} ms of "
        f"{wall_s * 1e3:.2f} ms wall ({total_us / 1e4 / wall_s:.1f}%), "
        f"{sum(e.count for e in rows)} kernels")
    rows.sort(key=lambda e: -e.self_device_time_total)
    # the eight largest, then the port's own kernels that are not among them
    own = [e for e in rows[8:] if any(k in e.key for k in PORT_KERNELS)]
    for e in rows[:8] + own:
        log(f"[profile] {name}:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    if kernels:
        counted = {n: k.launches for n, k in kernels.items()}
        traced = trace_launches(rows, list(kernels))
        log(f"[profile] {name}: the port's launches in the trace {traced}, by the "
            f"wrappers' counts {counted}")
        if traced != counted:
            raise AssertionError(f"{name}: the trace holds launches {traced}, the "
                                 f"wrappers counted {counted}")


def _check_shapes(res, qn, cap, name):
    import torch
    from repro_torch.utils import INVALID_ID
    if tuple(res.ids.shape) != (qn, cap) or tuple(res.count.shape) != (qn,):
        raise AssertionError(f"{name}: result shapes {tuple(res.ids.shape)}")
    valid = res.ids != INVALID_ID
    if not torch.equal(valid.sum(1).to(torch.int32), res.count):
        raise AssertionError(f"{name}: count != valid rows")
    return torch.nonzero(valid, as_tuple=True)


def check_result(res, points, queries, r, cap, name) -> None:
    """Shapes, padding, and every returned id truly in range at its exact
    distance (recomputed here in plain PyTorch)."""
    import torch
    from repro_torch.core import point_dist
    lane, slot = _check_shapes(res, queries.shape[0], cap, name)
    exact = point_dist(points[res.ids[lane, slot].long()], queries[lane], "l2")
    got = res.dists[lane, slot]
    if not torch.isfinite(got).all() or not (exact <= r + 1e-5).all():
        raise AssertionError(f"{name}: a returned id is out of range")
    if not torch.allclose(got, exact, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name}: returned distances are not exact")


def check_result_int8(res, points, queries, r, cap, name) -> None:
    """The int8 path returns exact distances only inside the band and
    certified lower bounds elsewhere: every returned id lies within r at
    its exact distance, no returned distance exceeds the exact one."""
    import torch
    from repro_torch.core import point_dist
    lane, slot = _check_shapes(res, queries.shape[0], cap, name)
    exact = point_dist(points[res.ids[lane, slot].long()], queries[lane], "l2")
    got = res.dists[lane, slot]
    if not torch.isfinite(got).all() or not (exact <= r + 1e-5).all():
        raise AssertionError(f"{name}: a returned id is out of range "
                             "(a false positive)")
    if not (got <= exact + 1e-5).all():
        raise AssertionError(f"{name}: a returned distance exceeds the exact one")


def check_guard_band(eng_q, points, queries, r, cfg, name, tol=1e-6):
    """The guard-band contract (tests/test_oracle.py (c)): on every lane
    whose buffer did not overflow, the post-rerank set equals the
    rerank-disabled set filtered by the exact distances. The exact
    distances here are recomputed in plain PyTorch, which sums in another
    order than the rerank kernel, so a pair within ``tol`` of r may fall
    either way; every other pair must be decided as the filter decides it.
    Returns (lanes checked, pairs within tol of r)."""
    import torch
    from repro_torch.core import point_dist
    from repro_torch.utils import INVALID_ID
    res = eng_q.range(queries, r, cfg=cfg)
    pre = eng_q.range(queries, r, cfg=dataclasses.replace(cfg, rerank=False))
    valid = pre.ids != INVALID_ID
    lane, slot = torch.nonzero(valid, as_tuple=True)
    exact = torch.full(pre.dists.shape, torch.inf, device=pre.dists.device)
    exact[lane, slot] = point_dist(points[pre.ids[lane, slot].long()],
                                   queries[lane], "l2")
    ids_post, ids_pre = res.ids.cpu().numpy(), pre.ids.cpu().numpy()
    sure_in = (valid & (exact <= r - tol)).cpu().numpy()
    maybe_in = (valid & (exact <= r + tol)).cpu().numpy()
    over = (res.overflow | pre.overflow).cpu().numpy()
    checked = 0
    for i in range(ids_post.shape[0]):
        if over[i]:
            continue
        got = set(ids_post[i][ids_post[i] != INVALID_ID].tolist())
        if not (set(ids_pre[i][sure_in[i]].tolist()) <= got
                <= set(ids_pre[i][maybe_in[i]].tolist())):
            raise AssertionError(f"{name}: guard-band contract broken on lane {i}")
        checked += 1
    return checked, int((maybe_in & ~sure_in).sum())


class _Recorder:
    """Stands in for a kernel wrapper: records each call's arguments, calls
    the wrapper, and reads and writes the wrapper's own counters (the
    wrapper counts through its module-level name)."""

    def __init__(self, inner, record):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "record", record)

    def __call__(self, *args, **kw):
        self.record(self.inner, args, kw)
        return self.inner(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        setattr(self.inner, name, value)


class ExpandCapture:
    """Swaps ``kernels.expand.ops``' two kernel wrappers for recorders that
    also keep each launch's inputs (frontier and queries cloned; corpus and
    adjacency, which the walk never writes, by reference) for a replay on
    each route. They launch what they wrap, so the counts and routes move
    as they would; used on the warm-up run only."""

    NAMES = {"expand_cuda": 2, "expand_int8_cuda": 3}   # the frontier's position

    def __init__(self):
        from repro_torch.kernels.expand import ops
        self.ops, self.kept = ops, []

    def _record(self, inner, args, kw):
        fi = self.NAMES[inner.__name__]
        self.kept.append((inner, [a.clone() if i in (fi, fi + 1) else a
                                  for i, a in enumerate(args)], dict(kw)))

    def __enter__(self):
        self.inner = {name: getattr(self.ops, name) for name in self.NAMES}
        for name, fn in self.inner.items():
            setattr(self.ops, name, _Recorder(fn, self._record))
        return self

    def __exit__(self, *exc):
        for name, fn in self.inner.items():
            setattr(self.ops, name, fn)


def served_replay(kept, name: str, row_bytes: int) -> dict:
    """The launches one served batch made, replayed on each route in one
    CUDA graph: every launch's outputs bit for bit equal on the two routes,
    each route's summed device time, and the bound of the whole batch (each
    launch's distinct kept rows, adjacency rows, inputs and outputs at the
    card's memory rate). Returns the entry's served_* numbers."""
    import torch
    if not kept:
        raise AssertionError(f"{name}: no expand launch was captured")
    kernel = kept[0][0]
    n_bytes = 0
    for fn, args, kw in kept:
        got = fn(*args, **kw)
        warp = fn(*args, **kw, route="warp")
        torch.cuda.synchronize()
        if not same_bits(got, warp):
            raise AssertionError(f"{name}: a served launch differs between the routes")
        n_bytes += expand_bytes(got[0], args[-2], args[-3], args[-1], row_bytes)
    routes = dict(kernel.routes)
    sums = {route: time_ms(lambda: [fn(*args, **kw, route=route) for fn, args, kw in kept],
                           reps=3, repeats=3)
            for route in ("bulk", "warp")}
    moved = {r: kernel.routes[r] - routes[r] for r in routes}
    if moved["bulk"] == 0 or moved["warp"] == 0:
        raise AssertionError(f"{name}: the replay moved the routes {moved}")
    n = len(kept)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    lanes = np.array([[args[-2].shape[0], int(((args[-2] >= 0) & (args[-2] < args[-3].shape[0]))
                                             .any(1).sum())] for _, args, _ in kept])
    log(f"[served] {name}: lanes a launch median {np.median(lanes[:, 0]):.0f} (max "
        f"{lanes[:, 0].max()}), live lanes median {np.median(lanes[:, 1]):.0f} (max "
        f"{lanes[:, 1].max()}, all launches {lanes[:, 1].sum()})")
    log(f"[served] {name}: {n} expand launches replayed in one CUDA graph: bulk "
        f"{sums['bulk']:.4f} ms ({sums['bulk'] / n * 1e3:.2f} us a launch), warp "
        f"{sums['warp']:.4f} ms ({sums['warp'] / n * 1e3:.2f} us a launch), "
        f"bulk/warp {sums['bulk'] / sums['warp']:.3f}; bound {bound:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB); every launch bitwise equal on the two routes")
    return dict(served_ms=sums["bulk"], served_warp_ms=sums["warp"],
                served_launches=n, served_bound_ms=bound)


def run_mode(engine, queries, r, cfg, kernels, profile: bool, name, capture=None):
    """One main-path run of one mode, with every launch and route count set
    to 0 just before and read just after; ``capture`` (a context) wraps the
    warm-up run. Returns (result, wall seconds, counts, routes)."""
    import torch
    with capture or contextlib.nullcontext():
        engine.range(queries, r, cfg=cfg)                  # warm-up
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
        if hasattr(k, "routes"):
            k.routes = dict.fromkeys(k.routes, 0)
    t0 = time.perf_counter()
    res = engine.range(queries, r, cfg=cfg, compacted=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: k.launches for n, k in kernels.items()}
    routes = {n: dict(k.routes) for n, k in kernels.items() if hasattr(k, "routes")}
    if profile:
        profile_run(lambda: engine.range(queries, r, cfg=cfg), dt, name, kernels)
    return res, dt, counts, routes


SERVED_ROUTES = {"expand": "bulk", "expand_int8": "bulk", "gatherdist_int8": "regs",
                 "rerank_fetch": "regs"}   # the route each kernel's served launches take


def check_routes(routes: dict, counts: dict, name: str, expect=None) -> None:
    """Every launch of a served run took the kernel's redesigned route
    (``SERVED_ROUTES``: expand's bulk, gatherdist-int8's regs), or the one
    ``expect`` names for it (rerank_fetch: its plan's for the band)."""
    for k, by_route in routes.items():
        served = (expect or {}).get(k, SERVED_ROUTES[k])
        want = {rt: counts[k] if rt == served else 0 for rt in by_route}
        if by_route != want:
            raise AssertionError(f"{name}: {k} routes {by_route} of {counts[k]} launches")


def kernel_route(kernel, fn) -> str:
    """Call ``fn`` (one call of ``kernel``'s wrapper) and name the route it
    took, by the wrapper's route counts."""
    before = dict(kernel.routes)
    fn()
    moved = [r for r, n in kernel.routes.items() if n != before[r]]
    if len(moved) != 1:
        raise AssertionError(f"{kernel.__name__}: one call moved the routes {moved}")
    return moved[0]


def rangescan_checks(queries, q1, items, r, launches: int, routes: dict):
    """rangescan against its plain version at k=128 and k=256, on the
    512-request batch, on 64 of its requests and on 1, every lane
    (``compare_scans`` excuses only what f32 rounding explains), with the
    route of each call; times at 512 requests and at 1 (k=256) against both
    bounds (the f32 pipes; three TF32 products on the tensor cores, the
    lower and the one the JSON entry carries), the SIMT route on the same
    inputs, the plain version and the product alone. ``launches`` and
    ``routes`` are the served batch's. Returns the JSON entry."""
    import torch
    from repro_torch.kernels.rangescan import rangescan_cuda, rangescan_dists, rangescan_ref
    from repro_torch.kernels.rangescan.ref import compare_scans
    n, d = items.shape
    max_err = 0.0
    for k in (128, 256):
        for name, qq in ((f"Q={queries.shape[0]}", queries), ("Q=64", queries[:64]),
                         ("Q=1", q1)):
            got = []
            route = kernel_route(rangescan_cuda, lambda: got.extend(rangescan_cuda(qq, items, r, k=k, metric="ip")))
            want = rangescan_ref(qq, items, r, k=k, metric="ip")
            dist = rangescan_dists(qq, items, "ip")
            torch.cuda.synchronize()
            excused, unexcused, err = compare_scans(got, want, dist, r, RANGESCAN_TOL)
            if unexcused:
                raise AssertionError(f"rangescan k={k} {name}: {unexcused} "
                                     "differences from the plain version beyond "
                                     "f32 rounding")
            max_err = max(max_err, err)
            log(f"[kernel] rangescan ip k={k} {name} N={n} d={d} route={route}: counts, "
                f"ids and ranks equal to the plain version on every lane but {excused} "
                f"excused (pairs within {RANGESCAN_TOL:g} of r or of each other), "
                f"max_abs_err={err:.3g}, in-range counts "
                f"{want[2].min().item()}..{want[2].max().item()}")
            del dist
    out = dict(name="rangescan", route="cuda",
               source="src/repro_torch/kernels/rangescan/csrc/rangescan.cu",
               replaces="src/repro/kernels/rangescan/kernel.py:73",
               launches=launches, max_abs_err=max_err)
    for qq, tag, reps in ((queries, "", 10), (q1, "q1_", 50)):
        qn = qq.shape[0]
        route = kernel_route(rangescan_cuda, lambda: rangescan_cuda(qq, items, r, k=256, metric="ip"))
        times = {k: time_ms(lambda: rangescan_cuda(qq, items, r, k=k, metric="ip"),
                            reps=reps, repeats=3) for k in (128, 256)}
        simt = time_ms(lambda: rangescan_cuda(qq, items, r, k=256, metric="ip", route="simt"),
                       reps=reps, repeats=3)
        plain = time_ms(lambda: rangescan_ref(qq, items, r, k=256, metric="ip"),
                        reps=2 if qn > 1 else 10, repeats=3, graph=False)
        lib = time_ms(lambda: torch.matmul(qq, items.T), reps=reps, repeats=3)
        n_bytes = n * d * 4 + qn * d * 4 + qn * 256 * 8 + qn * 4
        flops = 2.0 * qn * n * d
        b_f32, by_f32 = bound_ms(n_bytes, flops, F32_FLOPS)
        b_ms, b_by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS)
        ms = times[256]
        log(f"[kernel] rangescan ip Q={qn} N={n} d={d} route={route}: ms={ms:.4f} "
            f"(k=256), {times[128]:.4f} (k=128), {flops / ms / 1e9:.1f} TFLOP/s; "
            f"bound_ms={b_ms:.4f} ({b_by}, 3xTF32 on the tensor cores at "
            f"{TF32_FLOPS / 1e12:.0f} TFLOP/s, {b_ms / ms * 100:.1f}% of it), "
            f"f32-pipe bound {b_f32:.4f} ({by_f32}, {F32_FLOPS / 1e12:.0f} TFLOP/s, "
            f"{b_f32 / ms * 100:.1f}%); the simt route {simt:.4f} ms; plain_ms={plain:.4f}; "
            f"the product alone (torch.matmul, TF32 off) {lib:.4f} ms, "
            f"ratio {ms / lib:.3f}")
        out.update({f"{tag}ms": ms, f"{tag}plain_ms": plain,
                    f"{tag}bound_ms": b_ms, f"{tag}bound_by": b_by,
                    f"{tag}library_ms": lib, f"{tag}scan_route": route,
                    f"{tag}simt_ms": simt, f"{tag}f32_bound_ms": b_f32})
    out["routes"] = routes
    return out


def ip_radius(items, sample, dev, name: str) -> float:
    """The radius the paper's way (sweep + select_radius, half the sample
    answering empty) over unit vectors at ip."""
    from repro_torch.core import default_grid, exact_topk, match_histogram, select_radius, sweep
    t0 = time.perf_counter()
    base = default_grid(items, sample, metric="ip", num=48)
    # the sampled grid's low end already holds many matches among 1M items,
    # and a request answers empty below its nearest item's distance: extend
    # the grid down through the sample's nearest distances (finely) and to
    # -1, the least ip between unit vectors
    nearest = exact_topk(items, sample, k=1, metric="ip", device=dev)[1][:, 0]
    lo, hi = float(nearest.min()), float(nearest.max())
    grid = np.unique(np.concatenate([[-1.0], np.linspace(lo, hi, 128), base])
                     .astype(np.float32))
    prof = sweep(items, sample, grid, metric="ip", device=dev)
    r, gi = select_radius(prof, target_zero_frac=0.5)
    log(f"[radius] {name}: r={r:.6g} (grid index {gi} of {grid.size}, "
        f"{grid[0]:.4f}..{grid[-1]:.4f}; the sample's nearest items at "
        f"{lo:.4f}..{hi:.4f}, median {float(nearest.median()):.4f}; zero-result "
        f"fraction {prof.zero_frac[gi]:.3f} on {sample.shape[0]} requests; "
        f"{time.perf_counter() - t0:.2f} s); sample matches "
        f"{match_histogram(prof.counts[:, gi])}")
    return r


def two_tower_ap_probes(engine, items, queries, held, r, gt, cfg_r, dev) -> None:
    """Where the graph half's AP goes: held-out items as queries
    (similar-items retrieval) at their own radius, chosen the same way, and
    both kinds of query through a 4x beam and an 8x visit budget on the
    same graph. Prints only; it gates nothing."""
    from repro_torch.core import average_precision, exact_range_search, match_histogram
    r_ii = ip_radius(items, held[:256], dev, "two-tower ip (held-out items)")
    gt_ii = exact_range_search(items, held, r_ii, metric="ip", device=dev)
    gt_ii = (gt_ii[0].cpu().numpy(), gt_ii[2].cpu().numpy())
    res_ii = engine.range(held, r_ii, cfg=cfg_r)
    ap_ii = average_precision(*gt_ii, res_ii.ids.cpu().numpy(), res_ii.count.cpu().numpy())
    log(f"[two_tower] graph engine control, {held.shape[0]} held-out items as "
        f"queries: AP={ap_ii:.4f}, mean n_dist {float(res_ii.n_dist.float().mean()):.0f}, "
        f"matches {match_histogram(gt_ii[1])}")
    wide = dataclasses.replace(cfg_r, search=dataclasses.replace(
        cfg_r.search, beam=128, max_beam=128, visit_cap=1024))
    for name, qq, rr, (g_ids, g_cnt) in (("user requests", queries, r, gt),
                                         ("held-out items", held, r_ii, gt_ii)):
        res_w = engine.range(qq, rr, cfg=wide)
        ap_w = average_precision(g_ids, g_cnt, res_w.ids.cpu().numpy(),
                                 res_w.count.cpu().numpy())
        log(f"[two_tower] graph engine probe, beam=128 visit_cap=1024, {name}: "
            f"AP={ap_w:.4f}, mean n_dist {float(res_w.n_dist.float().mean()):.0f}")


def two_tower_phase(dev, kernels, ap_probes: bool = False, profile: bool = False) -> dict:
    """Two-tower retrieval serving at full width: the item corpus, the
    requests, the radius, brute-force serving through rangescan, the graph
    engine on the same corpus at ip, and rangescan against its plain
    version. ``ap_probes`` adds ``two_tower_ap_probes``; ``profile`` traces
    the brute-force batch. Returns the kernels JSON entry of rangescan."""
    import torch
    from repro_torch.configs.two_tower_retrieval import ARCH
    from repro_torch.core import (
        RangeConfig, RangeSearchEngine, SearchConfig, average_precision,
        build_knn_graph, exact_range_search, match_histogram, point_dist)
    from repro_torch.kernels.rangescan import rangescan
    from repro_torch.kernels.rangescan.ref import compare_scans
    from repro_torch.models import init_tower
    cfg = ARCH.model_cfg
    n_items = ARCH.shapes["retrieval_cand"].n_candidates
    n_req = ARCH.shapes["serve_p99"].global_batch
    k = 256                                   # examples/two_tower_range.py
    log(f"[two_tower] {ARCH.arch_id}: {cfg.n_sparse} user + "
        f"{cfg.tower_fields('item')} item fields, vocab {cfg.vocab:,}, d_embed "
        f"{cfg.d_embed}, towers {cfg.tower_dims('item')}, {n_items:,} items, "
        f"{n_req} requests (serve_p99) and 1 (retrieval_cand)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- the item corpus: item tower from seed 0, embedded in chunks, freed --
    item_sparse = np.random.default_rng(1).integers(
        0, cfg.vocab, (n_items, cfg.tower_fields("item")))
    t0 = time.perf_counter()
    tower = init_tower(cfg, "item", seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids = torch.as_tensor(item_sparse, device=dev)
    items = torch.empty((n_items, cfg.d_out), device=dev)
    for c0 in range(0, n_items, TT_CHUNK):
        items[c0:c0 + TT_CHUNK] = tower(ids[c0:c0 + TT_CHUNK])
    held = None
    if ap_probes:   # held-out items, the queries of the similar-items control
        held = tower(torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (n_req, cfg.tower_fields("item"))), device=dev))
    torch.cuda.synchronize()
    t_embed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    table_bytes = tower.tables.numel() * tower.tables.element_size()
    del tower, ids
    torch.cuda.empty_cache()
    norms = items.norm(dim=1)
    if not (torch.isfinite(items).all() and torch.allclose(norms, torch.ones_like(norms),
                                                           atol=1e-5)):
        raise AssertionError("item embeddings are not finite unit vectors")
    log(f"[two_tower] item tower (seed 0, tables {table_bytes / 1e9:.2f} GB) "
        f"built in {t_init:.2f} s; {n_items:,} items embedded in {t_embed:.2f} s "
        f"in chunks of {TT_CHUNK}; peak device memory {peak / 1e9:.2f} GB; item "
        f"tower freed; corpus ({n_items}, {cfg.d_out}) f32, unit norm")

    # -- the requests: user tower from seed 1 -------------------------------
    rng = np.random.default_rng(2)
    users = {name: torch.as_tensor(rng.integers(0, cfg.vocab, (b, cfg.n_sparse)),
                                   device=dev)
             for name, b in (("serve_p99", n_req), ("retrieval_cand", 1),
                             ("sample", 256))}
    t0 = time.perf_counter()
    user_tower = init_tower(cfg, "user", seed=1, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    queries = user_tower(users["serve_p99"])
    q1 = user_tower(users["retrieval_cand"])
    sample = user_tower(users["sample"])
    torch.cuda.synchronize()
    log(f"[two_tower] user tower (seed 1) built in {t_init:.2f} s; {n_req} + 1 + "
        f"256 requests embedded in {(time.perf_counter() - t0) * 1e3:.1f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # -- the radius, the paper's way, at ip ---------------------------------
    r = ip_radius(items, sample, dev, "two-tower ip")
    gt_ids, gt_d, gt_counts = exact_range_search(items, queries, r, metric="ip",
                                                 device=dev)
    gt1 = exact_range_search(items, q1, r, metric="ip", device=dev)
    gt_np, gc_np = gt_ids.cpu().numpy(), gt_counts.cpu().numpy()
    log(f"[oracle] two-tower: matches of the {n_req} requests "
        f"{match_histogram(gc_np)}; retrieval_cand {int(gt1[2][0])}")

    # -- brute-force serving: user tower + rangescan --------------------------
    def brute(u):
        return rangescan(user_tower(u), items, r, k=k, metric="ip")

    brute(users["serve_p99"])
    torch.cuda.synchronize()
    scan = kernels["rangescan"]
    for kern in kernels.values():
        kern.launches = 0
    scan.routes = dict.fromkeys(scan.routes, 0)
    t0 = time.perf_counter()
    ids_bf, d_bf, c_bf = brute(users["serve_p99"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: kern.launches for n, kern in kernels.items()}
    routes = dict(scan.routes)
    if counts["rangescan"] != 1 or routes != {**dict.fromkeys(routes, 0), "wgmma": 1}:
        raise AssertionError(f"brute force: launches {counts}, routes {routes}")
    q1_route = kernel_route(scan, lambda: brute(users["retrieval_cand"]))
    t0 = time.perf_counter()
    _, _, c_alone = rangescan(queries, items, r, k=k, metric="ip")
    torch.cuda.synchronize()
    dt_alone = time.perf_counter() - t0
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        brute(users["retrieval_cand"])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    _, unexcused, _ = compare_scans(
        (ids_bf, d_bf, c_bf), (gt_ids[:, :k], gt_d[:, :k], gt_counts),
        -(queries @ items.T), r, RANGESCAN_TOL)
    if unexcused or not torch.equal(c_bf, c_alone):
        raise AssertionError(f"brute force: {unexcused} differences from "
                             "exact_range_search beyond f32 rounding")
    c_np = c_bf.cpu().numpy()
    lo = gc_np <= k
    ap_lo = average_precision(gt_np[lo], gc_np[lo], ids_bf.cpu().numpy()[lo], c_np[lo])
    ap_hi = average_precision(gt_np[~lo], gc_np[~lo], ids_bf.cpu().numpy()[~lo],
                              np.minimum(c_np[~lo], k))
    log(f"[two_tower] brute force (user tower + rangescan, k={k}): "
        f"QPS={n_req / dt:.1f} ({dt * 1e3:.2f} ms for {n_req} requests; "
        f"rangescan alone {dt_alone * 1e3:.2f} ms), retrieval_cand latency "
        f"median {np.median(lat) * 1e3:.3f} ms (p90 {np.quantile(lat, 0.9) * 1e3:.3f}), "
        f"AP={ap_lo:.4f} on the {int(lo.sum())} lanes with count <= {k}, "
        f"AP={ap_hi:.4f} on the {int((~lo).sum())} lanes with count > {k} "
        f"(k of count), launches={counts}, routes={routes} (retrieval_cand: "
        f"{q1_route})")
    if profile:
        profile_run(lambda: brute(users["serve_p99"]), dt, "two-tower brute-force batch")

    # -- the graph engine on the same corpus, ip -------------------------------
    t0 = time.perf_counter()
    graph = build_knn_graph(items, k=32, metric="ip", device=dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    engine = RangeSearchEngine.from_graph(items, graph, metric="ip", n_starts=4,
                                          device=dev)
    cfg_r = RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128,
                                            metric="ip"),
                        mode="greedy", result_cap=512)

    def served(u):
        return engine.range(user_tower(u), r, cfg=cfg_r)

    served(users["serve_p99"])
    torch.cuda.synchronize()
    expand = kernels["expand"]
    for kern in kernels.values():
        kern.launches = 0
    expand.routes = dict.fromkeys(expand.routes, 0)
    t0 = time.perf_counter()
    res = served(users["serve_p99"])
    torch.cuda.synchronize()
    dt_g = time.perf_counter() - t0
    g_counts = {n: kern.launches for n, kern in kernels.items()}
    g_routes = dict(expand.routes)
    if min(g_counts["expand"], g_counts["gatherdist"]) == 0:
        raise AssertionError(f"graph engine: launches {g_counts}")
    check_routes({"expand": g_routes}, g_counts, "two-tower graph engine")
    lane, slot = _check_shapes(res, n_req, cfg_r.result_cap, "two-tower graph")
    exact = point_dist(items[res.ids[lane, slot].long()], queries[lane], "ip")
    if not (exact <= r + RANGESCAN_TOL).all():
        raise AssertionError("two-tower graph: a returned id is out of range")
    t0 = time.perf_counter()
    res_k = engine.range(queries, r, cfg=cfg_r)
    torch.cuda.synchronize()
    dt_alone = time.perf_counter() - t0
    ap_g = average_precision(gt_np, gc_np, res.ids.cpu().numpy(), res.count.cpu().numpy())
    log(f"[two_tower] graph engine (exact k-NN graph R=32 at ip, built in "
        f"{t_graph:.2f} s; greedy beam=32 visit_cap=128 result_cap=512): "
        f"QPS={n_req / dt_g:.1f} ({dt_g * 1e3:.2f} ms for {n_req} requests, user "
        f"tower included; search alone {dt_alone * 1e3:.2f} ms), AP={ap_g:.4f}, "
        f"mean n_dist {float(res.n_dist.float().mean()):.0f} vs {n_items:,} brute, "
        f"overflowed lanes={int(res.overflow.sum())}, launches={g_counts}, "
        f"expand routes {g_routes}")
    # expand and gatherdist against their plain versions at this path's
    # shapes (ip, d=256, 512 requests, R=32, E=4, S=4) on this corpus
    kernel_checks(items, graph.neighbors, queries,
                  torch.Generator(device=dev).manual_seed(SEED),
                  dtypes=("float32",), metrics=("ip",), widths=(4,),
                  tag=" (two-tower)")
    # the same engine through the plain versions of its kernels: the same
    # walk on every lane
    plain_cfg = dataclasses.replace(cfg_r, search=dataclasses.replace(
        cfg_r.search, use_kernels=False))
    res_p = engine.range(queries, r, cfg=plain_cfg)
    for field in ("ids", "count", "n_dist", "n_visited", "overflow"):
        if not torch.equal(getattr(res_k, field), getattr(res_p, field)):
            raise AssertionError(f"two-tower graph engine: {field} of the kernel "
                                 "and plain paths differ")
    err = check_close("two-tower graph engine", res_k.dists, res_p.dists,
                      DIST_TOL["float32"])
    ap_p = average_precision(gt_np, gc_np, res_p.ids.cpu().numpy(),
                             res_p.count.cpu().numpy())
    log(f"[plain] two-tower graph engine ip on {n_req} requests: AP kernel="
        f"{ap_g:.4f} plain={ap_p:.4f}; ids, counts, n_dist, n_visited and "
        f"overflow equal on every lane, max_abs_err={err:.3g}")
    if ap_probes:
        two_tower_ap_probes(engine, items, queries, held, r, (gt_np, gc_np), cfg_r, dev)
    del engine, graph, user_tower
    torch.cuda.empty_cache()

    return rangescan_checks(queries, q1, items, r, counts["rangescan"], routes)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


class AttentionCapture:
    """Swaps the LM layer's attention core for one that also keeps copies of
    its inputs, in the model's layouts, on the calls named in ``want``
    ({call index: tag}; call i of a run is layer i % L of its i // L-th
    forward). It launches what it wraps, so the kernel's count moves as it
    would; used on the warm-up run only."""

    def __init__(self, want: dict):
        from repro_torch.layers import attention
        self.mod, self.want, self.calls, self.kept = attention, want, 0, {}

    def __enter__(self):
        inner = self.inner = self.mod.flash_attention

        def core(q, k, v, **kw):
            tag = self.want.get(self.calls)
            if tag is not None:
                keep = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
                self.kept[tag] = (*keep, dict(kw))
            self.calls += 1
            return inner(q, k, v, **kw)

        self.mod.flash_attention = core
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.inner


def sdpa_library(q, k, v, kw):
    """The same function as one ``scaled_dot_product_attention`` call (no
    configuration sets a soft cap): no mask where every key is visible,
    ``is_causal`` where rows and keys start together, else a boolean mask
    made here. Returns the call."""
    import torch
    from repro_torch.kernels.flashattn.ref import visible_mask
    if kw["softcap"] > 0:
        raise ValueError("no library call applies a soft cap")
    sq, skv = q.shape[2], k.shape[2]
    mask = visible_mask(sq, skv, causal=kw["causal"], window=kw["window"],
                        q_offset=kw["q_offset"], device=q.device)
    if bool(mask.all()):
        how = {}
    elif kw["causal"] and kw["window"] <= 0 and kw["q_offset"] == 0 and sq == skv:
        how = dict(is_causal=True)
    else:
        how = dict(attn_mask=mask)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=kw["scale"], enable_gqa=True, **how)


def flash_checks(captured: dict, dev) -> dict:
    """flashattn against its plain version at the JAX tests' shapes (f32 and
    bf16) and on the captured inputs of the LM path (one global and one
    local layer, at prefill and at one decode step, all prompts); times by
    CUDA-graph replay against the bound, the plain version and one SDPA
    call. Returns the JSON entry (prefill global layer; decode_* the
    decode step's global layer)."""
    import torch
    from repro_torch.kernels.flashattn import flash_attention_cuda, flash_attention_ref
    from repro_torch.kernels.flashattn.ops import decode_splits, visible_key_range
    from repro_torch.kernels.flashattn.ref import visible_mask
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for (b, hq, hkv, sq, skv, dh, causal, window, cap, qoff) in FLASH_CASES:
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
        for dtype in ("float32", "bfloat16"):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
                       for shape in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)))
            route = kernel_route(flash_attention_cuda, lambda: flash_attention_cuda(q, k, v, **kw))
            got = flash_attention_cuda(q, k, v, **kw)
            want = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = check_close(f"flashattn {dtype} {(b, hq, hkv, sq, skv, dh)}",
                              got.float(), want.float(), FLASH_TOL[dtype])
            log(f"[kernel] flashattn {dtype} B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} "
                f"dh={dh} causal={causal} window={window} softcap={cap} "
                f"q_offset={qoff}: route {route}, max_abs_err={err:.3g}")
    entry = dict(name="flashattn", route="cuda",
                 source="src/repro_torch/kernels/flashattn/csrc/flashattn_wgmma.cu",
                 decode_source="src/repro_torch/kernels/flashattn/csrc/flashattn.cu",
                 replaces="src/repro/kernels/flashattn/kernel.py:33")
    for tag, (q, k, v, kw) in captured.items():
        route = kernel_route(flash_attention_cuda, lambda: flash_attention_cuda(q, k, v, **kw))
        got = flash_attention_cuda(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        lib_fn = sdpa_library(q, k, v, kw)
        lib_out = lib_fn()
        torch.cuda.synchronize()
        err = check_close(f"flashattn {tag}", got.float(), want.float(),
                          FLASH_TOL["bfloat16"])
        lib_err = float((lib_out.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        b, hq, sq, dh = q.shape
        skv = k.shape[2]
        decode = sq == 1
        ms = time_ms(lambda: flash_attention_cuda(q, k, v, **kw),
                     reps=200 if decode else 10, repeats=5)
        plain = time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                        reps=20 if decode else 2, repeats=3, graph=False)
        lib = time_ms(lib_fn, reps=200 if decode else 10, repeats=5)
        mask = visible_mask(sq, skv, causal=kw["causal"], window=kw["window"],
                            q_offset=kw["q_offset"], device=dev)
        flops = 4.0 * dh * int(mask.sum()) * b * hq
        # q and the output once each, and K and V of the keys some row sees
        # (at a local layer's decode step, its window)
        n_bytes = (2 * q.numel() + 2 * int(mask.any(0).sum()) * b * k.shape[1] * dh
                   ) * q.element_size()
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS)
        if decode:   # the split count as ops.py plans it for these inputs
            lo, hi = visible_key_range(sq, skv, causal=kw["causal"], window=kw["window"],
                                       q_offset=kw["q_offset"])
            splits = decode_splits(hi - lo, b * k.shape[1])
            how, rate = f"{splits} splits, ", f"{n_bytes / ms / 1e6:.1f} GB/s"
        else:
            how, rate = "", f"{flops / ms / 1e9:.1f} TFLOP/s"
        log(f"[kernel] flashattn {tag} B={b} Hq={hq} Hkv={k.shape[1]} Sq={sq} Skv={skv} "
            f"dh={dh} window={kw['window']} q_offset={kw['q_offset']} bf16: route {route} "
            f"({how}{rate}, {b_ms / ms:.1%} of the bound), "
            f"max_abs_err={err:.3g} (SDPA vs plain {lib_err:.3g}), ms={ms:.4f}, "
            f"plain_ms={plain:.4f}, bound_ms={b_ms:.4f} ({b_by}: {flops:.3g} flops at "
            f"989 TFLOP/s, {n_bytes / 1e6:.1f} MB at 3.35 TB/s; at the f32 rate "
            f"{flops / F32_FLOPS * 1e3:.4f} ms), library_ms={lib:.4f} "
            f"(scaled_dot_product_attention), {ms / lib:.3f}x SDPA, "
            f"{ms / b_ms:.2f}x the bound")
        want_route = "decode_split" if decode else "wgmma"
        if route != want_route:
            raise AssertionError(f"flashattn {tag}: route {route}, not {want_route}")
        times = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        if tag == "prefill global":
            entry.update(times, prefill_route=route)
        elif tag == "prefill local":
            entry.update({f"local_{k}": v for k, v in times.items()})
        elif tag == "decode global":
            entry.update({f"decode_{k}": v for k, v in times.items()}, decode_route=route)
        else:
            entry.update({f"decode_local_{k}": v for k, v in times.items()})
        del got, want, lib_out
        torch.cuda.empty_cache()
    entry["max_abs_err"] = max_err
    return entry


def lm_paths(model, toks, cfg, steps: int, feed=None):
    """prefill + ``steps`` decode steps of ``toks`` through ``cfg``'s path;
    the next token is the greedy one, or ``feed[t]`` (teacher forcing).
    Returns (last-token f32 logits a step, the tokens chosen, each layer's
    hidden state at the prompt's last position)."""
    import torch
    from repro_torch.models import decode_step, greedy_token, prefill
    hidden = []
    hooks = [layer.register_forward_hook(
        lambda mod, args, out: hidden.append(out[0, -1].float()) if out.shape[1] > 1 else None)
        for layer in model.layers]
    try:
        logits, cache, pos = prefill(model, toks, cfg, max_len=toks.shape[1] + steps)
        out, chosen = [logits[0, -1]], [greedy_token(logits)]
        for t in range(steps):
            tok = chosen[-1] if feed is None else feed[t]
            logits, cache = decode_step(model, tok, cache, pos, cfg)
            pos += 1
            out.append(logits[0, -1])
            chosen.append(greedy_token(logits))
    finally:
        for h in hooks:
            h.remove()
    return torch.stack(out), chosen, hidden


def lm_compare(model, toks, cfg, steps: int, limit: float, name: str) -> float:
    """The kernel path against the plain path (``use_kernels=False``) on
    the same model and prompt, the plain path fed the kernel path's tokens:
    the relative L2 error of the last-token logits at the prefill and each
    step must stay within ``limit``; the share of equal argmaxes and each
    layer's hidden-state error at the prompt's last position are printed."""
    import torch
    lk, chosen, hk = lm_paths(model, toks, cfg, steps)
    lp, _, hp = lm_paths(model, toks, dataclasses.replace(cfg, use_kernels=False),
                         steps, feed=chosen[:-1])
    torch.cuda.synchronize()
    errs = [rel_l2(a, b) for a, b in zip(lk, lp)]
    same = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    layer_errs = [rel_l2(a, b) for a, b in zip(hk, hp)]
    del lk, lp, hk, hp
    log(f"[lm] kernel vs plain path, {name}: relative L2 error of the last-token "
        f"logits max {max(errs):.3g} (prefill {errs[0]:.3g}; steps "
        f"{' '.join(f'{e:.2g}' for e in errs[1:])}), limit {limit:g}; argmax equal "
        f"on a share {same:.4f} of {len(errs)} (prefill + {steps} steps); "
        f"hidden-state error by layer at the prompt's last position: "
        f"{' '.join(f'{e:.2g}' for e in layer_errs)}")
    if max(errs) > limit:
        raise AssertionError(f"{name}: the kernel and plain paths part by "
                             f"{max(errs):.3g} > {limit:g}")
    return same


def lm_phase(dev, kernels, profile: bool = False) -> dict:
    """gemma3-27b serving at full width and depth: the model from seed 0 in
    bf16, 4 prompts of 4,096 tokens prefilled and 32 greedy decode steps
    (launches counted), the kernel path against the plain path (prompt 0,
    full depth, bf16; then depth 6 in f32), and flashattn against its plain
    version on the inputs this path gave it. ``profile`` traces one decode
    step. Returns the JSON entry."""
    import torch
    from repro_torch.configs.gemma3_27b import ARCH
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import decode_step, greedy_token, init_transformer, prefill
    cfg = ARCH.model_cfg
    windows, _ = cfg.layer_meta()
    n_layers = cfg.n_layers
    local, glob = int(np.flatnonzero(windows > 0)[0]), int(np.flatnonzero(windows == 0)[0])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_transformer(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[lm] {ARCH.arch_id}: {n_layers} layers ({int((windows > 0).sum())} local "
        f"window {cfg.window}, {int((windows == 0).sum())} global), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv} kv heads, dh {cfg.d_head}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab:,}, tied; built from seed {SEED} in "
        f"{t_build:.2f} s: {n_params:,} parameters, {w_bytes / 1e9:.2f} GB")
    if n_params != LM_PARAMS:
        raise AssertionError(f"{ARCH.arch_id} has {n_params:,} parameters, not {LM_PARAMS:,}")
    tokens = torch.as_tensor(lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=LM_PROMPT_LEN, batch=LM_PROMPTS, seed=SEED), 0)["tokens"],
        device=dev)

    # warm-up: a prefill and one decode step, keeping the attention inputs
    # of the first local and the first global layer
    want = {local: "prefill local", glob: "prefill global",
            n_layers + local: "decode local", n_layers + glob: "decode global"}
    with AttentionCapture(want) as cap:
        logits, cache, pos = prefill(model, tokens, cfg, max_len=LM_MAX_LEN)
        decode_step(model, greedy_token(logits), cache, pos, cfg)
    torch.cuda.synchronize()
    captured = cap.kept
    del logits, cache
    torch.cuda.empty_cache()

    # the served run, launches counted
    flash = kernels["flashattn"]
    for kern in kernels.values():
        kern.launches = 0
    flash.routes = dict.fromkeys(flash.routes, 0)
    t0 = time.perf_counter()
    logits, cache, pos = prefill(model, tokens, cfg, max_len=LM_MAX_LEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    n_prefill = flash.launches
    prefill_routes = dict(flash.routes)
    tok = greedy_token(logits)
    chosen, step_s = [tok], []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        logits, cache = decode_step(model, tok, cache, pos, cfg)
        tok = greedy_token(logits)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        pos += 1
        chosen.append(tok)
    counts = {n: k.launches for n, k in kernels.items()}
    decode_routes = {r: n - prefill_routes[r] for r, n in flash.routes.items()}
    if profile:
        # the last step again (its cache row rewritten): the cache is full
        profile_run(lambda: decode_step(model, tok, cache, pos - 1, cfg),
                    float(np.median(step_s)), "lm decode step")
    if n_prefill != n_layers or counts["flashattn"] != n_layers * (LM_STEPS + 1):
        raise AssertionError(f"flashattn launches: {n_prefill} at prefill, "
                             f"{counts['flashattn']} in all")
    if (prefill_routes != {"wgmma": n_layers, "tile_f32": 0, "decode_split": 0}
            or decode_routes != {"wgmma": 0, "tile_f32": 0,
                                 "decode_split": n_layers * LM_STEPS}):
        raise AssertionError(f"flashattn routes: {prefill_routes} at prefill, "
                             f"{decode_routes} over the steps")
    if tuple(logits.shape) != (LM_PROMPTS, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"decode logits {tuple(logits.shape)} not finite")
    toks_out = torch.cat(chosen, dim=1).cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    step_ms = np.median(step_s) * 1e3
    log(f"[lm] served {LM_PROMPTS} prompts x {LM_PROMPT_LEN} tokens (lm_batch seed "
        f"{SEED}), cache {tuple(cache.k.shape)} x 2 bf16 "
        f"({2 * cache.k.numel() * 2 / 1e9:.2f} GB): prefill {t_prefill * 1e3:.1f} ms "
        f"({LM_PROMPTS * LM_PROMPT_LEN / t_prefill:.1f} tokens/s); {LM_STEPS} greedy "
        f"decode steps, median {step_ms:.2f} ms a step (min {min(step_s) * 1e3:.2f}, "
        f"max {max(step_s) * 1e3:.2f}; {LM_PROMPTS / step_ms * 1e3:.1f} tokens/s); "
        f"peak device memory {peak / 1e9:.2f} GB; flashattn launches {n_prefill} at "
        f"prefill, {(counts['flashattn'] - n_prefill) // LM_STEPS} a step "
        f"({counts['flashattn']} in all), routes {prefill_routes} at prefill and "
        f"{decode_routes} over the steps; tokens of prompt 0 {toks_out[0, :8].tolist()}...")
    del logits, cache, chosen
    torch.cuda.empty_cache()

    # the kernel path against the plain path: full depth, bf16, prompt 0
    torch.cuda.reset_peak_memory_stats()
    lm_compare(model, tokens[:1], cfg, LM_STEPS, LM_BF16_REL,
               f"full depth bf16, prompt 0, {LM_STEPS} steps")
    log(f"[lm] peak device memory of the comparison "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()

    # the kernel against its plain version, on the card emptied of the model
    torch.cuda.reset_peak_memory_stats()
    entry = flash_checks(captured, dev)
    entry["launches"] = counts["flashattn"]
    del captured
    torch.cuda.empty_cache()
    log(f"[lm] peak device memory of the kernel checks "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # full width, depth 6 (one 5:1 period), f32
    torch.cuda.reset_peak_memory_stats()
    cfg6 = dataclasses.replace(cfg, n_layers=6, dtype=torch.float32)
    model = init_transformer(cfg6, seed=SEED, device=dev)
    same = lm_compare(model, tokens[:1], cfg6, 8, LM_F32_REL,
                      "full width, depth 6, f32, prompt 0, 8 steps")
    if same != 1.0:
        raise AssertionError("depth 6 f32: an argmax differs between the paths")
    log(f"[lm] peak device memory of the depth-6 f32 run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return entry


def graph_checks(nbrs, start) -> dict:
    """A built graph's rows on the device: no id out of range, no self
    loop, no duplicate within a row (fails otherwise); its degrees, and the
    share of nodes reachable from ``start`` (breadth first)."""
    import torch
    from repro_torch.utils import INVALID_ID
    n = nbrs.shape[0]
    valid = nbrs != INVALID_ID
    rows = torch.arange(n, device=nbrs.device)[:, None]
    srt = torch.sort(nbrs, dim=1).values
    bad = {"out of range": int((valid & ((nbrs < 0) | (nbrs >= n))).sum()),
           "self loops": int((nbrs == rows).sum()),
           "duplicates": int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != INVALID_ID)).sum())}
    if any(bad.values()):
        raise AssertionError(f"the built graph has bad entries {bad}")
    seen = torch.zeros(n, dtype=torch.bool, device=nbrs.device)
    seen[start] = True
    frontier, depth = start.reshape(1).long(), 0
    while frontier.numel():
        nb = nbrs[frontier].flatten()
        nb = torch.unique(nb[nb != INVALID_ID]).long()
        frontier = nb[~seen[nb]]
        seen[frontier] = True
        depth += 1
    deg = valid.sum(1)
    return dict(min=int(deg.min()), mean=float(deg.float().mean()), max=int(deg.max()),
                reachable=float(seen.float().mean()), depth=depth - 1)


def reset_counts(kernels: dict) -> None:
    for k in kernels.values():
        k.launches = 0
        if hasattr(k, "routes"):
            k.routes = dict.fromkeys(k.routes, 0)


def read_counts(kernels: dict) -> tuple[dict, dict]:
    return ({n: k.launches for n, k in kernels.items()},
            {n: dict(k.routes) for n, k in kernels.items() if hasattr(k, "routes")})


def vamana_phase(points, queries, r, cfg, q_cfg, ap_of, knn, kernels, profile):
    """[vamana]: the Vamana graph built on the card (the reference's serve
    CLI settings: R=32, beam 64, alpha 1.2, batches up to 1024, one pass),
    its build time and split, its launches, a check of every row, its
    degrees and reachability; then greedy f32 and int8 on it at the main
    path's settings beside the k-NN graph's QPS and AP, the kernel path against
    the plain path and the int8 guard-band contract. Returns (the f32
    engine, the build's launches)."""
    import torch
    from repro_torch.core import BuildConfig, RangeSearchEngine, build_vamana
    bcfg = BuildConfig(max_degree=32, beam=64, alpha=1.2, insert_batch=1024, metric="l2")
    build_kernels = {"expand": kernels["expand"], "gatherdist": kernels["gatherdist"]}
    reset_counts(build_kernels)
    split: dict = {}
    t0 = time.perf_counter()
    graph = build_vamana(points, bcfg, seed=SEED, device=points.device, timings=split)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, routes = read_counts(build_kernels)
    if min(counts.values()) == 0:
        raise AssertionError(f"[vamana] the build launched no kernel of {counts}")
    check_routes(routes, counts, "vamana build")
    engine = RangeSearchEngine.from_graph(points, graph, metric="l2", n_starts=4,
                                          device=points.device)
    g = graph_checks(graph.neighbors, engine.start_ids[0])
    if profile:    # one full-width insert batch into the built graph, traced
        from repro_torch.core import insert_batch_step
        from repro_torch.core.graph import medoid
        batch = torch.from_numpy(np.random.default_rng(SEED).permutation(
            points.shape[0])[:bcfg.insert_batch].astype(np.int32)).to(points.device)
        start = medoid(points)[None]
        step = lambda: insert_batch_step(points, graph.neighbors, batch, start, bcfg,  # noqa: E731
                                         bcfg.alpha)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        profile_run(step, time.perf_counter() - t0, "vamana insert batch", build_kernels)
    log(f"[vamana] build_vamana n={points.shape[0]} R={bcfg.max_degree} "
        f"beam={bcfg.beam} alpha={bcfg.alpha} insert_batch={bcfg.insert_batch} "
        f"seed={SEED} on the card in {dt:.2f} s: search {split['search']:.2f} s, "
        f"prune {split['prune']:.2f} s, reverse edges {split['reverse']:.2f} s; "
        f"launches {counts}, routes {routes}")
    log(f"[vamana] graph: no id out of range, no self loop, no duplicate in a row; "
        f"degree min {g['min']} mean {g['mean']:.2f} max {g['max']}; reachable from "
        f"the medoid {g['reachable']:.6f} (depth {g['depth']})")
    engine_q = RangeSearchEngine.from_graph(points, graph, metric="l2", n_starts=4,
                                            corpus_dtype="int8", device=points.device)
    sub = queries[:256]
    f32_k = {k: kernels[k] for k in ("expand", "gatherdist")}
    q_k = {k: kernels[k] for k in ("expand_int8", "gatherdist_int8", "rerank_fetch")}
    for name, eng, c, kern in (("greedy f32", engine, cfg, f32_k),
                               ("greedy int8 f32-query", engine_q, q_cfg, q_k)):
        res, wall, cnt, rts = run_mode(eng, queries, r, c, kern, profile, f"vamana {name}")
        if min(cnt.values()) == 0:
            raise AssertionError(f"[vamana] {name}: a kernel was never launched {cnt}")
        check_routes(rts, cnt, f"vamana {name}", {"rerank_fetch": sys.modules[
            "repro_torch.kernels.rerank_fetch.ops"].plan(int(res.n_rerank.sum()),
                                                         points.shape[1])})
        if eng is engine:
            check_result(res, points, queries, r, c.result_cap, f"vamana {name}")
        else:
            check_result_int8(res, points, queries, r, c.result_cap, f"vamana {name}")
        ap = ap_of(res)
        plain = dataclasses.replace(c, search=dataclasses.replace(c.search, use_kernels=False))
        ap_k, ap_p = ap_of(eng.range(sub, r, cfg=c), 256), ap_of(eng.range(sub, r, cfg=plain), 256)
        if abs(ap_k - ap_p) > 0.01:
            raise AssertionError(f"[vamana] {name}: kernel and plain AP differ by "
                                 f"{abs(ap_k - ap_p):.4f}")
        log(f"[vamana] {name}: QPS={N_QUERIES / wall:.1f} ({wall * 1e3:.1f} ms), "
            f"AP={ap:.4f} (the k-NN graph's in this call: QPS={knn[name][1]:.1f}, "
            f"AP={knn[name][0]:.4f}), mean "
            f"n_visited={float(res.n_visited.float().mean()):.1f}, mean n_dist="
            f"{float(res.n_dist.float().mean()):.1f}, phase-2 share="
            f"{float(res.phase2.float().mean()):.4f}, overflowed lanes="
            f"{int(res.overflow.sum())}, launches={cnt}, routes {rts}; on 256 queries "
            f"AP kernel={ap_k:.4f} plain={ap_p:.4f}")
        if eng is engine_q:
            n_ok, n_tie = check_guard_band(engine_q, points, sub, r, c, f"vamana {name}")
            log(f"[guard] vamana int8 {name} on 256 queries: post-rerank set == "
                f"rerank-disabled set filtered by the exact distances on {n_ok} lanes; "
                f"{n_tie} pairs within 1e-6 of r")
    del engine_q
    return engine, counts


FILTER_LABELS = 16          # benchmarks/run.py's filtered row: 16 labels, 1-2 a point
FILTER_QUERIES = 128
FILTER_SEED = 17
MAX_FILTERED_AP_GAP = 0.01  # benchmarks/run.py's gate


def filtered_phase(engine, points, queries, prof, deploy, fetch_kernel):
    """[filtered]: the reference benchmark's filtered workload
    (benchmarks/run.py:420-505) at full size on the Vamana engine: 16
    labels, 1-2 a point (seed 17, drawn as one vectorized pair a point:
    the same distribution as the reference's per-point draws, another
    sequence); 128 queries whose lanes alternate one-label AND (~9 % of the
    corpus) and four-label OR (~35 %); the radius whose mean match count on
    the sweep sample is nearest 128. Unfiltered and filtered QPS and AP (the
    latter against the post-filtered oracle; gap <= 0.01); then the
    selective lanes again with filter_threshold at 1.5x their largest
    selectivity: every lane on the fallback scan (n_visited == 0), its
    answers equal to the post-filtered oracle as sets but for pairs within
    1e-5 relative of r. Returns the fallback run's rerank_fetch launches."""
    import torch
    from repro_torch.core import (
        average_precision, exact_range_search, label_match_counts, labels_match,
        make_label_filter, pack_labels, point_dist)
    from repro_torch.utils import INVALID_ID
    dev = points.device
    n = points.shape[0]
    rng = np.random.default_rng(FILTER_SEED)
    k = rng.integers(1, 3, n)
    first = rng.integers(0, FILTER_LABELS, n)
    second = (first + rng.integers(1, FILTER_LABELS, n)) % FILTER_LABELS
    member = np.zeros((n, FILTER_LABELS), bool)
    member[np.arange(n), first] = True
    member[np.arange(n)[k == 2], second[k == 2]] = True
    eng = dataclasses.replace(engine, labels=torch.from_numpy(
        pack_labels(member, FILTER_LABELS).view(np.int32)).to(dev))
    qs = queries[:FILTER_QUERIES]
    entries = [[q % FILTER_LABELS] if q % 2 == 0
               else [(q + j) % FILTER_LABELS for j in range(4)] for q in range(FILTER_QUERIES)]
    modes = ["and" if q % 2 == 0 else "or" for q in range(FILTER_QUERIES)]
    filt = make_label_filter(entries, FILTER_LABELS, modes=modes)
    mean_counts = prof.counts.mean(axis=0)
    r = float(prof.radii[int(np.argmin(np.abs(mean_counts - 128.0)))])
    cfg = deploy.overrides(beam=32, max_beam=32, visit_cap=128).range_cfg
    gt_ids, gt_d, gt_counts = exact_range_search(points, qs, r, cap=16384, device=dev)
    if int(gt_counts.max()) > gt_ids.shape[1]:
        raise AssertionError("[filtered] the oracle's cap is below a lane's count")
    valid = gt_ids != INVALID_ID
    ok = valid & labels_match(eng.labels[torch.where(valid, gt_ids, 0).long()],
                              filt.masks.to(dev)[:, None, :], filt.is_and.to(dev)[:, None])
    order = torch.sort((~ok).to(torch.int8), dim=1, stable=True).indices
    gt_f = torch.gather(torch.where(ok, gt_ids, INVALID_ID), 1, order).cpu().numpy()
    gt_f_counts = ok.sum(1).cpu().numpy()
    gt_np, gt_counts_np = gt_ids.cpu().numpy(), gt_counts.cpu().numpy()
    sel_frac = label_match_counts(eng.labels, filt).cpu().numpy() / n

    def timed(q, c, f=None):
        eng.range(q, r, cfg=c, filter=f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.range(q, r, cfg=c, filter=f)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res_u, t_u = timed(qs, cfg)
    res_f, t_f = timed(qs, cfg, filt)
    ap_u = average_precision(gt_np, gt_counts_np, res_u.ids.cpu().numpy(),
                             res_u.count.cpu().numpy())
    ap_f = average_precision(gt_f, gt_f_counts, res_f.ids.cpu().numpy(),
                             res_f.count.cpu().numpy())
    log(f"[filtered] {FILTER_QUERIES} queries, r={r:.6g} (mean matches "
        f"{float(gt_counts.float().mean()):.1f}, filtered {gt_f_counts.mean():.1f}); "
        f"selectivity AND lanes {sel_frac[::2].mean():.4f}, OR lanes "
        f"{sel_frac[1::2].mean():.4f}: unfiltered QPS={FILTER_QUERIES / t_u:.1f} "
        f"AP={ap_u:.4f}; filtered QPS={FILTER_QUERIES / t_f:.1f} AP={ap_f:.4f} "
        f"(post-filtered oracle), gap {ap_u - ap_f:+.4f} (limit {MAX_FILTERED_AP_GAP})")
    if ap_u - ap_f > MAX_FILTERED_AP_GAP:
        raise AssertionError(f"[filtered] filtered AP trails unfiltered by {ap_u - ap_f:.4f}")

    sel = np.arange(0, FILTER_QUERIES, 2)
    qs_sel = qs[torch.from_numpy(sel).to(dev)]
    filt_sel = make_label_filter([entries[i] for i in sel], FILTER_LABELS, modes="and")
    thr = min(0.999, float(sel_frac[::2].max()) * 1.5)
    res_w, t_w = timed(qs_sel, cfg, filt_sel)
    fb_cfg = dataclasses.replace(cfg, filter_threshold=thr)
    eng.range(qs_sel, r, cfg=fb_cfg, filter=filt_sel)
    torch.cuda.synchronize()
    reset_counts({"rerank_fetch": fetch_kernel})
    t0 = time.perf_counter()
    res_fb = eng.range(qs_sel, r, cfg=fb_cfg, filter=filt_sel)
    torch.cuda.synchronize()
    t_fb = time.perf_counter() - t0
    launches, routes = read_counts({"rerank_fetch": fetch_kernel})
    if not bool((res_fb.n_visited == 0).all()) or launches["rerank_fetch"] != 1:
        raise AssertionError(f"[filtered] fallback: n_visited "
                             f"{res_fb.n_visited.tolist()}, launches {launches}")
    excused, pairs = 0, int(res_fb.n_dist.sum())
    ids_fb = res_fb.ids.cpu().numpy()
    for j, lane in enumerate(sel):
        got = set(ids_fb[j][ids_fb[j] != INVALID_ID].tolist())
        want = set(gt_f[lane][:gt_f_counts[lane]].tolist())
        for i in got ^ want:
            d = float(point_dist(points[i], qs[lane], "l2"))
            if abs(d - r) > 1e-5 * abs(r):
                raise AssertionError(f"[filtered] fallback lane {lane}: id {i} at "
                                     f"{d:.8g} against r={r:.8g}")
            excused += 1
    log(f"[filtered] fallback on the {sel.size} selective lanes, filter_threshold="
        f"{thr:.4f}: every lane n_visited == 0, answers equal to the post-filtered "
        f"oracle as sets on every lane ({excused} pairs within 1e-5 of r excused); "
        f"QPS={sel.size / t_fb:.1f} against the walk's {sel.size / t_w:.1f} on the same "
        f"lanes ({t_w / t_fb:.2f}x); {pairs} exact pairs in {launches['rerank_fetch']} "
        f"rerank_fetch launch, route {[k for k, v in routes['rerank_fetch'].items() if v]}")
    return launches["rerank_fetch"]


def tier_phase(engine_q, points, graph, queries, r, q_cfg, fetch_kernel):
    """[tier]: ``from_graph(corpus_dtype="int8", tier=True)`` on the same
    graph under the greedy int8 setting, 4096 queries, two calls (cold, then
    warm), at the default cache (n/8 rows) and at a cache of a third of the
    greedy band's distinct rows (so that it evicts): ids, dists, count and
    n_rerank equal to the resident int8 engine's bit for bit in every call,
    each rerank on the resident call's route. Returns the tier's
    rerank_fetch launches."""
    import torch
    from repro_torch.core import RangeSearchEngine
    before = dict(fetch_kernel.routes)
    want = engine_q.range(queries, r, cfg=q_cfg)
    torch.cuda.synchronize()
    resident_route = {k: fetch_kernel.routes[k] - before[k] for k in before}
    t0 = time.perf_counter()
    engine_q.range(queries, r, cfg=q_cfg)
    torch.cuda.synchronize()
    t_res = time.perf_counter() - t0
    resident = engine_q.points
    res_bytes = sum(t.numel() * t.element_size() for t in (resident.codes, resident.meta,
                                                           resident.raw))
    launches, band_rows = 0, None
    for small in (False, True):
        # the second tier's cache holds a third of the band's distinct rows
        mb = band_rows * points.shape[1] * 4 / 3 / 2**20 if small else None
        label = f"resident_mb={mb:.2f}" if small else "default cache (n/8 rows)"
        t0 = time.perf_counter()
        eng_t = RangeSearchEngine.from_graph(points, graph, metric="l2", n_starts=4,
                                             corpus_dtype="int8", tier=True,
                                             resident_mb=mb, device=points.device)
        torch.cuda.synchronize()
        t_make = time.perf_counter() - t0
        tier = eng_t.points
        for call in ("cold", "warm"):
            before = dict(fetch_kernel.routes)
            t0 = time.perf_counter()
            got = eng_t.range(queries, r, cfg=q_cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            moved = {k: fetch_kernel.routes[k] - before[k] for k in before}
            launches += sum(moved.values())
            if moved != resident_route:
                raise AssertionError(f"[tier] {label} {call}: rerank routes {moved}, "
                                     f"the resident call's {resident_route}")
            for f in ("ids", "dists", "count", "n_rerank"):
                if not torch.equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"[tier] {label} {call}: {f} differs from the "
                                         "resident int8 engine's")
            c = tier.counters.as_dict()
            band_rows = band_rows or c["unique_rows"]
            log(f"[tier] {label} {call}: ids, dists, count, n_rerank bit for bit the "
                f"resident engine's; QPS={N_QUERIES / dt:.1f} against resident "
                f"{N_QUERIES / t_res:.1f}; rerank route {moved}; counters so far: "
                f"pairs {c['pairs']}, unique rows {c['unique_rows']}, hits "
                f"{c['cache_hits']}, misses {c['cache_misses']}, fetched "
                f"{c['fetched_bytes'] / 1e6:.1f} MB in {c['fetch_batches']} buckets, "
                f"evictions {c['cache_evictions']}")
        b = tier.budget()
        log(f"[tier] {label}: made in {t_make:.2f} s; cache {tier.cache.capacity} rows; "
            f"device {b.device_total / 1e6:.1f} MB ({b.device}) against the resident "
            f"corpus's {res_bytes / 1e6:.1f} MB; host store {b.host_total / 1e6:.1f} MB "
            f"(pinned {tier.store.pinned})")
        if mb is not None and tier.counters.cache_evictions == 0:
            raise AssertionError("[tier] the small cache never evicted")
        del eng_t, tier
    return launches


SERVE_MAX_BATCH = 128       # the reference serve CLI's defaults (src/repro/launch/serve.py)
SERVE_LANES = 32
SERVE_SLICE_ROUNDS = 8
SERVE_CALIBRATION = 256     # the CLI fits the effort regressor on 256 requests
TAIL_REQUESTS = 1024        # benchmarks/run.py's tail row: one heavy lane in 16
TAIL_HEAVY_EVERY = 16
TAIL_POINT_MATCHES = 4.0
TAIL_HEAVY_MATCHES = 512.0
SERVE_PLAIN_REQUESTS = 256
MAX_SERVE_AP_GAP = 0.01     # kernel path against plain path, as [plain]


def drive_server(server, queries_np, radii):
    """Submit every request (backing off on queue_full by serving a step,
    as the serve CLI does) and serve until drained; the host's wall time
    and the responses sorted by request id."""
    import torch
    from repro_torch.serve import Request
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp = []
    for i in range(queries_np.shape[0]):
        rq = Request(req_id=i, query=queries_np[i], radius=float(radii[i]))
        while server.submit(rq) is not None:
            resp.extend(server.step())
    resp.extend(server.run_until_drained())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    resp.sort(key=lambda x: x.req_id)
    if [x.req_id for x in resp] != list(range(queries_np.shape[0])):
        raise AssertionError("[serve] a request went unanswered or twice")
    return resp, wall


def served_arrays(resp, cap: int):
    """(ids (Q, cap) INVALID-padded, counts) of range responses, for AP."""
    from repro_torch.utils import INVALID_ID
    ids = np.full((len(resp), cap), INVALID_ID, np.int64)
    counts = np.zeros(len(resp), np.int64)
    for i, x in enumerate(resp):
        ids[i, :len(x.ids)] = x.ids
        counts[i] = len(x.ids)
    return ids, counts


def latency_line(lat) -> str:
    return (f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
            f"{np.percentile(lat, 99) * 1e3:.3f} ms")


def check_against_engine(resp, want, exact_dists: bool, points, queries, r, name) -> int:
    """Every response equals its lane of ``engine.range``: ids, count,
    overflow, es_stopped, and (f32) the distances' bits. An int8 lane may
    differ only by an id whose exact distance is within 1e-6 of r (the
    band's exact distances come from rerank_fetch, whose route follows the
    band's size: 128 lanes and 4,096 do not take the same route). Returns
    the number of such excused ids."""
    from repro_torch.core import point_dist
    from repro_torch.utils import INVALID_ID
    w_ids, w_d, w_c, w_o, w_e = (t.cpu().numpy() for t in (
        want.ids, want.dists, want.count, want.overflow, want.es_stopped))
    excused = 0
    for i, x in enumerate(resp):
        keep = w_ids[i] != INVALID_ID
        same = np.array_equal(x.ids, w_ids[i][keep])
        if exact_dists:
            same = same and np.array_equal(x.dists.view(np.int32), w_d[i][keep].view(np.int32))
        if same and (x.count, x.overflow, x.es_stopped) == (w_c[i], w_o[i], w_e[i]):
            continue
        if exact_dists:
            raise AssertionError(f"[serve] {name}: request {i} differs from engine.range "
                                 f"(count {x.count} against {w_c[i]})")
        for j in set(x.ids.tolist()) ^ set(w_ids[i][keep].tolist()):
            d = float(point_dist(points[j], queries[i], "l2"))
            if abs(d - r) > 1e-6 * abs(r):
                raise AssertionError(f"[serve] {name}: request {i} id {j} at {d:.9g} "
                                     f"differs from engine.range (r={r:.9g})")
            excused += 1
        if x.overflow != w_o[i] or x.es_stopped != w_e[i]:
            raise AssertionError(f"[serve] {name}: request {i} flags differ")
    return excused


def serve_phase(engine, points, queries, r, prof, cfg, q_cfg, kernels, gt):
    """[serve]: the serving layer (``repro_torch.serve.RangeServer``) on the
    Vamana engine at 1M x 128 with the reference serve CLI's settings
    (max_batch 128, 32 lanes, 8 rounds a slice; the effort regressor fitted
    on 256 calibration requests with their exact counts). Lockstep, f32 and
    int8: the 4,096 requests at r, each response equal to
    ``engine.range``'s lane; requests/s beside engine.range's QPS, exact
    latency percentiles. Then benchmarks/run.py's tail workload (every 16th
    request at the radius of ~512 mean matches, the rest at ~4) served in
    lockstep and continuously (after a warm-up pass of each): per request
    the same ids, count and overflow; AP of both against the oracle; point
    p50/p99, heavy p99, the point-p99 ratio and the pool counters. A
    256-request continuous pass on the plain path gives AP within 0.01 of
    the kernel path. Every path kernel must launch through the server.
    ``gt`` is the oracle's (ids, counts) at r. Returns the server's
    launches per kernel."""
    import torch
    from repro_torch.core import (
        RangeSearchEngine, average_precision, exact_range_search)
    from repro_torch.models import EffortPredictor
    from repro_torch.serve import RangeServer, ServerConfig
    dev = points.device
    card = card_line()
    engine_q = RangeSearchEngine.from_graph(points, engine.graph, metric="l2", n_starts=4,
                                            corpus_dtype="int8", device=dev)
    path = {"float32": ("expand", "gatherdist"),
            "int8": ("expand_int8", "gatherdist_int8", "rerank_fetch")}
    launches = dict.fromkeys(kernels, 0)

    def counted(kind, fn, name):
        reset_counts(kernels)
        out = fn()
        counts, _ = read_counts(kernels)
        missing = [k for k in path[kind] if counts[k] == 0]
        if missing:
            raise AssertionError(f"[serve] {name}: {missing} never launched {counts}")
        for k, v in counts.items():
            launches[k] += v
        return out, counts

    q_np = queries.cpu().numpy()
    lock_cfg = ServerConfig(max_batch=SERVE_MAX_BATCH, lanes=SERVE_LANES,
                            slice_rounds=SERVE_SLICE_ROUNDS)
    cont_cfg = dataclasses.replace(lock_cfg, continuous=True)
    engines = {"float32": (engine, cfg), "int8": (engine_q, q_cfg)}
    radii_all = np.full(q_np.shape[0], r, np.float32)
    for kind, (eng, c) in engines.items():
        eng.range(queries, r, cfg=c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = eng.range(queries, r, cfg=c)
        torch.cuda.synchronize()
        t_range = time.perf_counter() - t0
        srv = RangeServer(eng, c, lock_cfg)
        (resp, wall), counts = counted(kind, lambda: drive_server(srv, q_np, radii_all),
                                       f"lockstep {kind}")
        excused = check_against_engine(resp, want, kind == "float32", points, queries, r,
                                       f"lockstep {kind}")
        ids, cnt = served_arrays(resp, c.result_cap)
        ap = average_precision(gt[0], gt[1], ids, cnt)
        lat = np.array([x.latency_s for x in resp])
        log(f"[serve] lockstep {kind}: {len(resp)} requests at r={r:.6g}, max_batch "
            f"{SERVE_MAX_BATCH} ({srv.stats['batches']} micro-batches): "
            f"{len(resp) / wall:.1f} requests/s against engine.range's "
            f"{len(resp) / t_range:.1f} QPS on the same queries; latency "
            f"{latency_line(lat)} (exact, {len(lat)} responses); AP={ap:.4f}; every "
            f"response equal to engine.range's lane (ids, count, overflow, es_stopped"
            f"{', distance bits' if kind == 'float32' else f'; {excused} ids within 1e-6 of r excused'}); "
            f"reranked {srv.stats['reranked']}; launches {counts}; card {card}")

    # -- the tail workload ----------------------------------------------------
    mean_counts = prof.counts.mean(axis=0)
    r_point = float(prof.radii[int(np.argmin(np.abs(mean_counts - TAIL_POINT_MATCHES)))])
    r_heavy = float(prof.radii[int(np.argmin(np.abs(mean_counts - TAIL_HEAVY_MATCHES)))])
    nq = TAIL_REQUESTS
    radii = np.full(nq, r_point, np.float32)
    radii[::TAIL_HEAVY_EVERY] = r_heavy
    point = radii == r_point
    tq = queries[:nq]
    gt_ids, _, gt_counts = exact_range_search(points, tq, torch.from_numpy(radii).to(dev),
                                              cap=4096, device=dev)
    gt_ids, gt_counts = gt_ids.cpu().numpy(), gt_counts.cpu().numpy()
    ncal = SERVE_CALIBRATION
    t0 = time.perf_counter()
    effort = EffortPredictor.fit(q_np[:ncal], radii[:ncal], gt_counts[:ncal], device=dev)
    t_fit = time.perf_counter() - t0
    split_ok = float(np.mean((effort.predict(q_np[:nq], radii) >= cont_cfg.effort_threshold)
                             == ~point))
    log(f"[serve] tail workload: {nq} requests, every {TAIL_HEAVY_EVERY}th at r_heavy="
        f"{r_heavy:.6g} (mean matches {gt_counts[~point].mean():.1f}), the rest at r_point="
        f"{r_point:.6g} ({gt_counts[point].mean():.2f}); effort regressor fitted on the "
        f"card on {ncal} requests in {t_fit:.2f} s (300 AdamW steps); its split at "
        f"{cont_cfg.effort_threshold:g} matches agrees with the radius class on {split_ok:.4f} of the requests")

    def ap_resp(resp, k=nq):
        ids, cnt = served_arrays(resp, cfg.result_cap)
        return average_precision(gt_ids[:k], gt_counts[:k], ids, cnt)

    for kind, (eng, c) in engines.items():
        tq_np = q_np[:nq]
        drive_server(RangeServer(eng, c, lock_cfg), tq_np, radii)               # warm-up
        drive_server(RangeServer(eng, c, cont_cfg, effort=effort), tq_np, radii)
        srv_l = RangeServer(eng, c, lock_cfg)
        (resp_l, wall_l), cnt_l = counted(kind, lambda: drive_server(srv_l, tq_np, radii),
                                          f"tail lockstep {kind}")
        srv_c = RangeServer(eng, c, cont_cfg, effort=effort)
        (resp_c, wall_c), cnt_c = counted(kind, lambda: drive_server(srv_c, tq_np, radii),
                                          f"tail continuous {kind}")
        for a, b in zip(resp_l, resp_c):
            if (set(a.ids.tolist()) != set(b.ids.tolist()) or a.count != b.count
                    or a.overflow != b.overflow):
                raise AssertionError(f"[serve] tail {kind}: request {a.req_id} differs "
                                     "between continuous and lockstep")
        s = srv_c.stats
        if not (s["pool_admitted"] and s["bucket_heavy"] and s["bucket_cheap"]):
            raise AssertionError(f"[serve] tail {kind}: the pool or a bucket never ran {s}")
        lat_l = np.array([x.latency_s for x in resp_l])
        lat_c = np.array([x.latency_s for x in resp_c])
        p99 = {m: float(np.percentile(v[point], 99)) for m, v in (("l", lat_l), ("c", lat_c))}
        pool = {k: s[k] for k in ("pool_admitted", "pool_retired", "pool_ticks",
                                  "pool_rotations", "pool_oneshot", "bucket_cheap",
                                  "bucket_heavy")}
        log(f"[serve] tail {kind}: continuous equals lockstep on every request (id set, "
            f"count, overflow); AP lockstep={ap_resp(resp_l):.4f} continuous="
            f"{ap_resp(resp_c):.4f}; lockstep {nq / wall_l:.1f} requests/s, point "
            f"{latency_line(lat_l[point])}, heavy p99 "
            f"{np.percentile(lat_l[~point], 99) * 1e3:.3f} ms; continuous {nq / wall_c:.1f} "
            f"requests/s, point {latency_line(lat_c[point])}, heavy p99 "
            f"{np.percentile(lat_c[~point], 99) * 1e3:.3f} ms; point p99 ratio "
            f"(continuous/lockstep) {p99['c'] / p99['l']:.4f}; pool {pool}; launches "
            f"lockstep {cnt_l} continuous {cnt_c}; card {card}")

    # -- the kernel path against the plain path, continuous -------------------
    k = SERVE_PLAIN_REQUESTS
    plain = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, use_kernels=False))
    aps = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        resp, _ = drive_server(RangeServer(engine, c, cont_cfg, effort=effort), q_np[:k],
                               radii[:k])
        aps[name] = ap_resp(resp, k)
    log(f"[serve] continuous f32 on {k} tail requests: AP kernel={aps['kernel']:.4f} "
        f"plain={aps['plain']:.4f}")
    if abs(aps["kernel"] - aps["plain"]) > MAX_SERVE_AP_GAP:
        raise AssertionError(f"[serve] kernel and plain AP differ by "
                             f"{abs(aps['kernel'] - aps['plain']):.4f}")
    del engine_q
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="corpus size")
    ap.add_argument("--profile", action="store_true",
                    help="also trace each mode's main-path run, the two-tower "
                         "brute-force batch and one LM decode step with "
                         "torch.profiler and print the device-time breakdown")
    ap.add_argument("--result-cap", type=int, default=1024,
                    help="result buffer per query (the deployment's 1024); "
                         "another value is the AP-gap probe, and also runs "
                         "the two-tower graph half's AP probes")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ModuleNotFoundError:
        print(f"chip_smoke: the port's package is not in {ROOT}/src: run this "
              "script from a checkout of the repo", file=sys.stderr)
        return 1
    from repro_torch.configs.range_engine import EngineDeployConfig
    from repro_torch.core import (
        RangeSearchEngine, average_precision, build_knn_graph, default_grid,
        exact_range_search, match_histogram, quantize_corpus, select_radius, sweep)
    from repro_torch.data import make_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.expand import expand_cuda, expand_int8_cuda
    from repro_torch.kernels.flashattn import flash_attention_cuda
    from repro_torch.kernels.gatherdist import gatherdist_cuda, gatherdist_int8_cuda
    from repro_torch.kernels.rangescan import rangescan_cuda
    from repro_torch.kernels.rerank_fetch import rerank_fetch_cuda
    fetch_ops = sys.modules["repro_torch.kernels.rerank_fetch.ops"]

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. kernels ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc sm_90a, one process per source)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- 9. two-tower retrieval serving (first: its tables need the card) ----
    with torch.inference_mode():
        tt_entry = two_tower_phase(dev, {
            "rangescan": rangescan_cuda, "expand": expand_cuda,
            "gatherdist": gatherdist_cuda},
            ap_probes=args.result_cap != ap.get_default("result_cap"), profile=args.profile)
    log(f"[two_tower] peak device memory of the phase "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    # -- 10. LM serving (second: its 54 GB of weights need the card too) -----
    with torch.inference_mode():
        lm_entry = lm_phase(dev, {"flashattn": flash_attention_cuda}, args.profile)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- 2. data and graph ---------------------------------------------------
    t0 = time.perf_counter()
    ds = make_corpus("bigann-like", n=args.n, n_queries=N_QUERIES, seed=SEED)
    points = torch.as_tensor(ds.points, device=dev)
    queries = torch.as_tensor(ds.queries, device=dev)
    log(f"[data] bigann-like n={args.n} d={points.shape[1]} "
        f"queries={N_QUERIES} seed={SEED} "
        f"({time.perf_counter() - t0:.2f} s)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = build_knn_graph(points, k=32, metric="l2", device=dev)
    torch.cuda.synchronize()
    log(f"[graph] exact k-NN graph R=32 built on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    qc = quantize_corpus(points)
    torch.cuda.synchronize()
    log(f"[int8] corpus quantized on the card in {time.perf_counter() - t0:.3f} s "
        f"(codes {tuple(qc.codes.shape)} int8, meta {tuple(qc.meta.shape)} f32)")

    # -- 3. kernels against their plain versions -----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    entries = kernel_checks(points, graph.neighbors, queries, gen)
    entries.update(int8_kernel_checks(qc, graph.neighbors, queries, gen))
    del qc

    # -- 4. radius -----------------------------------------------------------
    t0 = time.perf_counter()
    sample = queries[:256]
    # default_grid's low end is the 0.05% quantile of a 2048-point sample's
    # distances; at 1M points that radius already holds ~500 matches, so
    # the grid is extended three decades down to reach zero-result radii
    grid = default_grid(ds.points, ds.queries[:256], num=48)
    grid = np.geomspace(grid[0] / 1e3, grid[-1], 96).astype(np.float32)
    prof = sweep(points, sample, grid, device=dev)
    # target: half the queries answer empty. (At the paper's default of
    # 0.95 almost no lane saturates its beam on this corpus, and greedy
    # phase 2 would not run at all.)
    r, gi = select_radius(prof, target_zero_frac=0.5)
    log(f"[radius] r={r:.6g} (grid index {gi}, zero-result fraction "
        f"{prof.zero_frac[gi]:.3f} on 256 queries, "
        f"{time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    gt_ids, _, gt_counts = exact_range_search(points, queries, r, device=dev)
    torch.cuda.synchronize()
    gt_ids, gt_counts = gt_ids.cpu().numpy(), gt_counts.cpu().numpy()
    log(f"[oracle] exact_range_search over {N_QUERIES} queries in "
        f"{time.perf_counter() - t0:.2f} s; matches {match_histogram(gt_counts)}")

    def ap_of(res, k=N_QUERIES):
        return average_precision(gt_ids[:k], gt_counts[:k], res.ids.cpu().numpy(),
                                 res.count.cpu().numpy())

    # -- 5. the f32 main path ------------------------------------------------
    engine = RangeSearchEngine.from_graph(points, graph, metric="l2",
                                          n_starts=4, device=dev)
    deploy = EngineDeployConfig().overrides(result_cap=args.result_cap)
    cfgs = {"greedy": deploy.range_cfg,
            "beam": deploy.overrides(mode="beam").range_cfg,
            "doubling": deploy.overrides(mode="doubling", max_beam=256).range_cfg}
    f32_kernels = {"expand": expand_cuda, "gatherdist": gatherdist_cuda}
    launches, aps, qps = {}, {}, {}
    captures = {}   # the expand launches of the greedy batches, for the replay
    for mode, cfg in cfgs.items():
        cap = ExpandCapture() if mode == "greedy" else None
        if cap:
            captures["f32"] = cap
        res, dt, counts, routes = run_mode(engine, queries, r, cfg, f32_kernels,
                                           args.profile, mode, cap)
        if min(counts.values()) == 0:
            raise AssertionError(f"{mode}: a kernel was never launched {counts}")
        check_routes(routes, counts, mode)
        launches[mode] = counts
        check_result(res, points, queries, r, cfg.result_cap, mode)
        aps[mode] = ap_of(res)
        qps[mode] = N_QUERIES / dt
        log(f"[main] {mode}: QPS={N_QUERIES / dt:.1f} ({dt * 1e3:.1f} ms for "
            f"{N_QUERIES} queries), AP={aps[mode]:.4f}, "
            f"mean n_visited={float(res.n_visited.float().mean()):.1f}, "
            f"phase-2 share={float(res.phase2.float().mean()):.4f}, "
            f"overflowed lanes={int(res.overflow.sum())}, "
            f"launches={counts}, expand routes {routes['expand']}, "
            f"results {match_histogram(res.count.cpu().numpy())}")

    # -- 6. the int8 main path -----------------------------------------------
    t0 = time.perf_counter()
    engine_q = RangeSearchEngine.from_graph(points, graph, metric="l2",
                                            n_starts=4, corpus_dtype="int8",
                                            device=dev)
    torch.cuda.synchronize()
    stats = engine_q.stats()
    log(f"[int8] from_graph(corpus_dtype='int8') in {time.perf_counter() - t0:.2f} s: "
        f"corpus_dtype={stats['corpus_dtype']}, hot_bytes_per_vector="
        f"{stats['hot_bytes_per_vector']} (f32: {engine.stats()['hot_bytes_per_vector']})")
    int8_kernels = {"expand_int8": expand_int8_cuda,
                    "gatherdist_int8": gatherdist_int8_cuda,
                    "rerank_fetch": rerank_fetch_cuda}
    deploy_q = deploy.overrides(corpus_dtype="int8")
    q_cfgs = {"greedy f32-query": deploy_q.range_cfg,
              "beam f32-query": deploy_q.overrides(mode="beam").range_cfg,
              "doubling f32-query": deploy_q.overrides(mode="doubling", max_beam=256).range_cfg,
              "greedy int8-query": deploy_q.overrides(use_expand_kernel=True).range_cfg}
    q_launches, q_aps = {}, {}
    for name, cfg in q_cfgs.items():
        cap = ExpandCapture() if name.startswith("greedy") else None
        if cap:
            captures[name] = cap
        res, dt, counts, routes = run_mode(engine_q, queries, r, cfg, int8_kernels,
                                           args.profile, f"int8 {name}", cap)
        band = int(res.n_rerank.sum())
        check_routes(routes, counts, f"int8 {name}",
                     {"rerank_fetch": fetch_ops.plan(band, points.shape[1])})
        # expand-int8 runs every iteration and gatherdist-int8 seeds every
        # lane; rerank_fetch launches once for a batch with a band, and a
        # batch whose every kept candidate is a sure member launches nothing
        if (min(counts["expand_int8"], counts["gatherdist_int8"]) == 0
                or counts["rerank_fetch"] != int(band > 0)
                or (name.startswith("greedy") and band == 0)):
            raise AssertionError(f"int8 {name}: launches {counts} with a band "
                                 f"of {band} pairs")
        q_launches[name] = counts
        check_result_int8(res, points, queries, r, cfg.result_cap, f"int8 {name}")
        ap = q_aps[name] = ap_of(res)
        qps[f"int8 {name}"] = N_QUERIES / dt
        f32_ap = aps[name.split()[0]]
        log(f"[main] int8 {name}: QPS={N_QUERIES / dt:.1f} ({dt * 1e3:.1f} ms for "
            f"{N_QUERIES} queries), AP={ap:.4f} (f32 {f32_ap:.4f}, gap "
            f"{f32_ap - ap:+.4f}), mean n_rerank="
            f"{float(res.n_rerank.float().mean()):.2f}, band P={band}, "
            f"mean n_visited={float(res.n_visited.float().mean()):.1f}, "
            f"phase-2 share={float(res.phase2.float().mean()):.4f}, "
            f"overflowed lanes={int(res.overflow.sum())}, "
            f"launches={counts}, routes {routes}, no false "
            f"positive, results {match_histogram(res.count.cpu().numpy())}")
    entries["rerank_fetch"] = rerank_at_band(
        engine_q, queries, r, q_cfgs["greedy f32-query"],
        q_launches["greedy f32-query"]["rerank_fetch"])

    # the expand launches the greedy batches made, replayed on each route
    dim = points.shape[1]
    entries["expand"].update(served_replay(captures.pop("f32").kept, "greedy f32",
                                           4 * dim))
    entries["expand_int8"].update(served_replay(
        captures.pop("greedy f32-query").kept, "greedy int8 f32-query", dim + 12))
    entries["expand_int8"].update({f"int8_query_{k}": v for k, v in served_replay(
        captures.pop("greedy int8-query").kept, "greedy int8 int8-query",
        dim + 12).items()})
    torch.cuda.empty_cache()

    # -- 7. the guard-band contract ------------------------------------------
    sub = queries[:256]
    for name, cfg in q_cfgs.items():
        n_ok, n_tie = check_guard_band(engine_q, points, sub, r, cfg,
                                       f"int8 {name}")
        log(f"[guard] int8 {name} on 256 queries: post-rerank set == "
            f"rerank-disabled set filtered by the exact distances on {n_ok} "
            f"lanes (the rest overflowed result_cap); {n_tie} pairs within "
            f"1e-6 of r")

    # -- 8. kernel path against the plain path through the engines -----------
    runs = [(mode, engine, cfg) for mode, cfg in cfgs.items()]
    runs += [(f"int8 {name}", engine_q, cfg) for name, cfg in q_cfgs.items()]
    for name, eng, cfg in runs:
        plain_cfg = dataclasses.replace(cfg, search=dataclasses.replace(
            cfg.search, use_kernels=False))
        res_k = eng.range(sub, r, cfg=cfg)
        res_p = eng.range(sub, r, cfg=plain_cfg)
        ap_k, ap_p = ap_of(res_k, 256), ap_of(res_p, 256)
        same = float((res_k.ids == res_p.ids).all(1).float().mean())
        log(f"[plain] {name} on 256 queries: AP kernel={ap_k:.4f} "
            f"plain={ap_p:.4f}, lanes with identical ids={same:.4f}")
        if abs(ap_k - ap_p) > 0.01:
            raise AssertionError(f"{name}: kernel and plain AP differ by "
                                 f"{abs(ap_k - ap_p):.4f}")

    # -- 11. the tiered corpus on the k-NN graph against the resident one ----
    tier_launches = tier_phase(engine_q, points, graph, queries, r,
                               q_cfgs["greedy f32-query"], rerank_fetch_cuda)
    knn = {"greedy f32": (aps["greedy"], qps["greedy"]),
           "greedy int8 f32-query": (q_aps["greedy f32-query"],
                                     qps["int8 greedy f32-query"])}
    del engine, engine_q
    torch.cuda.empty_cache()

    # -- 12. the Vamana graph built on the card, and searched ----------------
    kernels = {**f32_kernels, **int8_kernels}
    engine_v, build_launches = vamana_phase(
        points, queries, r, cfgs["greedy"], q_cfgs["greedy f32-query"], ap_of, knn,
        kernels, args.profile)

    # -- 13. filtered range search on the Vamana graph -------------------------
    fallback_launches = filtered_phase(engine_v, points, queries, prof, deploy,
                                       rerank_fetch_cuda)

    # -- 14. the serving layer on the Vamana engine ----------------------------
    t0 = time.perf_counter()
    serve_launches = serve_phase(engine_v, points, queries, r, prof, cfgs["greedy"],
                                 q_cfgs["greedy f32-query"], kernels, (gt_ids, gt_counts))
    log(f"[serve] phase took {time.perf_counter() - t0:.1f} s")
    del engine_v

    for name in ("expand", "gatherdist"):
        entries[name]["launches"] = launches["greedy"][name]
        entries[name]["build_launches"] = build_launches[name]
    for name, n in serve_launches.items():
        entries[name]["serve_launches"] = n
    entries["rerank_fetch"]["fallback_launches"] = fallback_launches
    entries["rerank_fetch"]["tier_launches"] = tier_launches
    for name in ("expand_int8", "gatherdist_int8"):
        entries[name]["launches"] = q_launches["greedy f32-query"][name]
    entries["rangescan"] = tt_entry
    entries["flashattn"] = lm_entry
    log(f"[main] peak device memory of the engine phases "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(card_line())
    extra = ("form", "int8_query_ms", "expand_route", "warp_ms", "served_ms",
             "served_warp_ms", "served_launches", "served_bound_ms",
             "int8_query_warp_ms", "int8_query_served_ms", "int8_query_served_warp_ms",
             "int8_query_served_launches", "int8_query_served_bound_ms", "scan_route", "simt_ms", "f32_bound_ms", "q1_ms",
             "q1_plain_ms", "q1_bound_ms", "q1_bound_by", "q1_library_ms", "q1_scan_route",
             "q1_simt_ms", "q1_f32_bound_ms", "routes", "prefill_route", "local_ms",
             "local_bound_ms", "local_library_ms", "decode_source", "decode_route",
             "decode_ms", "decode_plain_ms", "decode_bound_ms",
             "decode_bound_by", "decode_library_ms", "decode_local_ms",
             "decode_local_bound_ms", "decode_local_library_ms", "gather_route",
             "old_route_ms", "floor_ms", "main_shape_ms", "main_shape_old_route_ms",
             "main_shape_bound_ms", "int8_query_gather_route", "int8_query_old_route_ms",
             "int8_query_main_shape_ms", "int8_query_main_shape_old_route_ms",
             "int8_query_main_shape_bound_ms", "fetch_route", "cold_ms",
             "old_route_cold_ms", "build_launches", "fallback_launches", "tier_launches",
             "serve_launches")
    log(json.dumps({"kernels": [
        {k: entries[n][k] for k in ENTRY_KEYS + extra if k in entries[n]}
        for n in ("expand", "gatherdist", "expand_int8", "gatherdist_int8",
                  "rerank_fetch", "rangescan", "flashattn")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
