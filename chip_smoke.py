#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

    python3 chip_smoke.py                 # full size: N=1M, d=128, Q=4096
    python3 chip_smoke.py --n 100000      # a shorter rehearsal

Phases, each printed as it ends:
  1. build the CUDA kernels from the sources in the checkout (nvcc, sm_90a);
     print the build time and the card's name and power limit;
  2. a bigann-like corpus from a seed and its exact k-NN graph (R=32);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (time, bound, plain version's time);
  4. the radius, chosen the paper's way (sweep + select_radius) on a
     256-query sample, for half the queries to answer empty;
  5. the main path: ``RangeSearchEngine.range(compacted=True)`` on all
     queries in greedy, beam and doubling modes (QPS, AP against
     ``exact_range_search``, match histogram, launches of each kernel);
  6. the kernel path against the plain path through the same engine on a
     256-query subset (AP within 0.01).

The search configuration is the repo's single-shard deployment,
``EngineDeployConfig`` in src/repro/configs/range_engine.py: 1M points per
shard, d=128, R=32, l2, f32 corpus, beam=64, visit_cap=256, E=4, greedy,
result_cap=1024, frontier_rounds=2048, 4096-query batches. Any failure
exits non-zero. The last line is the device JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
DIST_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),  # sum order differs
            "bfloat16": dict(rtol=1e-2, atol=1e-5)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Device time of one call: ``fn`` is captured once in a CUDA graph and
    replayed ``reps`` times between two CUDA events, so the host's launch
    overhead is not counted; the median over ``repeats`` such runs."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def check_close(name, got, want, tol) -> float:
    import torch
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{name}: +inf pattern differs from the plain version")
    if not torch.allclose(got[fin], want[fin], **tol):
        raise AssertionError(f"{name}: distances differ beyond {tol}")
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def kernel_checks(points, nbrs, queries, gen):
    """Each kernel against its plain version at the main path's shapes.
    Returns the JSON entries of the f32 l2 configuration the main path
    runs."""
    import torch
    from repro_torch.kernels.expand import expand_cuda, expand_frontier_ref
    from repro_torch.kernels.gatherdist import gatherdist_cuda, gatherdist_ref
    from repro_torch.utils import INVALID_ID
    n, d = points.shape
    r = nbrs.shape[1]
    qn, e = queries.shape[0], 4
    dev = points.device
    frontier = torch.randint(0, n, (qn, e), generator=gen, device=dev,
                             dtype=torch.int32)
    frontier[::8, 3] = INVALID_ID            # exhausted frontier slots
    frontier[::16, 1] = frontier[::16, 0]    # duplicate frontier nodes
    entries = {}
    for dtype in ("float32", "bfloat16"):
        pts = points.to(getattr(torch, dtype)).contiguous()
        for metric in ("l2", "ip"):
            args = (pts, nbrs, frontier, queries)
            ids, dd, nd = expand_cuda(*args, metric=metric)
            rids, rd, rnd = expand_frontier_ref(*args, metric=metric)
            torch.cuda.synchronize()
            if not (torch.equal(ids, rids) and torch.equal(nd, rnd)):
                raise AssertionError(f"expand {dtype} {metric}: ids/n_dist differ")
            err = check_close(f"expand {dtype} {metric}", dd, rd, DIST_TOL[dtype])
            ms = time_ms(lambda: expand_cuda(*args, metric=metric))
            plain = time_ms(lambda: expand_frontier_ref(*args, metric=metric))
            kept = ids[ids != INVALID_ID]
            f_ok = frontier[(frontier >= 0) & (frontier < n)]
            n_bytes = (torch.unique(kept).numel() * d * pts.element_size()
                       + torch.unique(f_ok).numel() * r * 4
                       + frontier.numel() * 4 + queries.numel() * 4
                       + ids.numel() * 8 + nd.numel() * 4)
            flops = kept.numel() * (3 if metric == "l2" else 2) * d
            b_ms, b_by = bound_ms(n_bytes, flops)
            log(f"[kernel] expand {dtype} {metric} Q={qn} E={e} R={r} d={d}: "
                f"ids/n_dist equal, max_abs_err={err:.3g}, ms={ms:.4f}, "
                f"plain_ms={plain:.4f}, bound_ms={b_ms:.4f} ({b_by}, "
                f"{n_bytes / 1e6:.1f} MB), gathered rows={kept.numel()}")
            if (dtype, metric) == ("float32", "l2"):
                entries["expand"] = dict(
                    name="expand", route="cuda",
                    source="src/repro_torch/kernels/expand/csrc/expand.cu",
                    replaces="src/repro/kernels/expand/kernel.py:49",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)
        for s in (4, 32):
            ids = torch.randint(0, n, (qn, s), generator=gen, device=dev,
                                dtype=torch.int32)
            ids[::5, -1] = INVALID_ID
            for metric in ("l2", "ip"):
                args = (pts, ids, queries)
                got = gatherdist_cuda(*args, metric=metric)
                want = gatherdist_ref(*args, metric=metric)
                torch.cuda.synchronize()
                err = check_close(f"gatherdist {dtype} {metric} S={s}", got,
                                  want, DIST_TOL[dtype])
                ms = time_ms(lambda: gatherdist_cuda(*args, metric=metric))
                plain = time_ms(lambda: gatherdist_ref(*args, metric=metric))
                ok = ids[(ids >= 0) & (ids < n)]
                n_bytes = (torch.unique(ok).numel() * d * pts.element_size()
                           + ids.numel() * 8 + queries.numel() * 4)
                flops = ok.numel() * (3 if metric == "l2" else 2) * d
                b_ms, b_by = bound_ms(n_bytes, flops)
                log(f"[kernel] gatherdist {dtype} {metric} Q={qn} S={s} d={d}: "
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


def profile_run(fn, wall_s: float, name: str) -> None:
    """Device time by kernel over one traced run of ``fn``, and the device's
    busy share of ``wall_s``, the untraced run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel rows only: the CPU-side op rows carry their kernels' time too
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError(f"{name}: the profiler recorded no device time")
    total_us = sum(e.self_device_time_total for e in rows)
    log(f"[profile] {name}: device busy {total_us / 1e3:.2f} ms of "
        f"{wall_s * 1e3:.2f} ms wall ({total_us / 1e4 / wall_s:.1f}%), "
        f"{sum(e.count for e in rows)} kernels")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile] {name}:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


def check_result(res, points, queries, r, cap, name) -> None:
    """Shapes, padding, and every returned id truly in range at its exact
    distance (recomputed here in plain PyTorch)."""
    import torch
    from repro_torch.core import point_dist
    from repro_torch.utils import INVALID_ID
    qn = queries.shape[0]
    if tuple(res.ids.shape) != (qn, cap) or tuple(res.count.shape) != (qn,):
        raise AssertionError(f"{name}: result shapes {tuple(res.ids.shape)}")
    valid = res.ids != INVALID_ID
    if not torch.equal(valid.sum(1).to(torch.int32), res.count):
        raise AssertionError(f"{name}: count != valid rows")
    lane, slot = torch.nonzero(valid, as_tuple=True)
    exact = point_dist(points[res.ids[lane, slot].long()], queries[lane], "l2")
    got = res.dists[lane, slot]
    if not torch.isfinite(got).all() or not (exact <= r + 1e-5).all():
        raise AssertionError(f"{name}: a returned id is out of range")
    if not torch.allclose(got, exact, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name}: returned distances are not exact")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="corpus size")
    ap.add_argument("--profile", action="store_true",
                    help="also trace each mode's main-path run with "
                         "torch.profiler and print its device-time breakdown")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import (
        RangeConfig, RangeSearchEngine, SearchConfig, average_precision,
        build_knn_graph, default_grid, exact_range_search, match_histogram,
        select_radius, sweep)
    from repro_torch.data import make_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.expand import expand_cuda
    from repro_torch.kernels.gatherdist import gatherdist_cuda

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

    # -- 3. kernels against their plain versions -----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    entries = kernel_checks(points, graph.neighbors, queries, gen)

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

    # -- 5. the main path ----------------------------------------------------
    engine = RangeSearchEngine.from_graph(points, graph, metric="l2",
                                          n_starts=4, device=dev)
    search = SearchConfig(beam=64, max_beam=64, visit_cap=256, expand_width=4)
    cfgs = {
        "greedy": RangeConfig(search=search, mode="greedy", result_cap=1024,
                              frontier_rounds=2048),
        "beam": RangeConfig(search=search, mode="beam", result_cap=1024),
        "doubling": RangeConfig(search=SearchConfig(
            beam=64, max_beam=256, visit_cap=256, expand_width=4),
            mode="doubling", result_cap=1024),
    }
    launches = {}
    aps = {}
    for mode, cfg in cfgs.items():
        engine.range(queries, r, cfg=cfg)                  # warm-up
        torch.cuda.synchronize()
        expand_cuda.launches = gatherdist_cuda.launches = 0
        t0 = time.perf_counter()
        res = engine.range(queries, r, cfg=cfg, compacted=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"expand": expand_cuda.launches,
                  "gatherdist": gatherdist_cuda.launches}
        if min(counts.values()) == 0:
            raise AssertionError(f"{mode}: a kernel was never launched {counts}")
        launches[mode] = counts
        check_result(res, points, queries, r, cfg.result_cap, mode)
        ap = average_precision(gt_ids, gt_counts, res.ids.cpu().numpy(),
                               res.count.cpu().numpy())
        aps[mode] = ap
        log(f"[main] {mode}: QPS={N_QUERIES / dt:.1f} ({dt * 1e3:.1f} ms for "
            f"{N_QUERIES} queries), AP={ap:.4f}, "
            f"mean n_visited={float(res.n_visited.float().mean()):.1f}, "
            f"phase-2 share={float(res.phase2.float().mean()):.4f}, "
            f"launches={counts}, results {match_histogram(res.count.cpu().numpy())}")
        if args.profile:
            profile_run(lambda: engine.range(queries, r, cfg=cfg), dt, mode)

    # -- 6. kernel path against the plain path through the engine ------------
    sub = queries[:256]
    for mode, cfg in cfgs.items():
        plain_cfg = dataclasses.replace(cfg, search=dataclasses.replace(
            cfg.search, use_kernels=False))
        res_k = engine.range(sub, r, cfg=cfg)
        res_p = engine.range(sub, r, cfg=plain_cfg)
        ap_k, ap_p = (average_precision(gt_ids[:256], gt_counts[:256],
                                        x.ids.cpu().numpy(), x.count.cpu().numpy())
                      for x in (res_k, res_p))
        same = float((res_k.ids == res_p.ids).all(1).float().mean())
        log(f"[plain] {mode} on 256 queries: AP kernel={ap_k:.4f} "
            f"plain={ap_p:.4f}, lanes with identical ids={same:.4f}")
        if abs(ap_k - ap_p) > 0.01:
            raise AssertionError(f"{mode}: kernel and plain AP differ by "
                                 f"{abs(ap_k - ap_p):.4f}")

    for name in entries:
        entries[name]["launches"] = launches["greedy"][name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(card_line())
    log(json.dumps({"kernels": [{k: entries[n][k] for k in keys}
                                for n in ("expand", "gatherdist")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
