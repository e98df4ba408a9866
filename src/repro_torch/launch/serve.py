"""Serving launcher: build an index over a corpus and serve range queries.

  PYTHONPATH=src python -m repro_torch.launch.serve --profile bigann-like \\
      --n 20000 --queries 512 --mode greedy --early-stop --mixed-radius
  PYTHONPATH=src python -m repro_torch.launch.serve --n 20000 --churn 0.1
  PYTHONPATH=src python -m repro_torch.launch.serve --n 2000 --device cpu

Builds the synthetic corpus, selects a radius with the paper's Sec.-3
methodology, builds the Vamana index, starts the RangeServer and drives a
batch of requests through it, reporting QPS / AP / early-stop stats.
``--shards S`` serves through the fault-tolerant host fan-out; add
``--replicas R`` (and optionally ``--hedge-ms`` and ``--down-replicas``)
to serve an R-way replicated fleet with hedged reads, circuit breakers and
replica recovery: coverage stays 1.0 while any replica of every shard
survives. ``--mixed-radius`` spreads per-request radii across the corpus's
match distribution; the server batches them together and answers each
request at its own radius. ``--churn FRAC`` serves from a **live** index:
insert and delete requests for FRAC of the corpus interleave with the
queries in the same admission queue, the server applies them between
micro-batches (epoch snapshots), and AP is scored against the exact oracle
on the FINAL live set. Everything runs on ``--device`` (the card unless
``cpu`` is asked for).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..configs.range_engine import EngineDeployConfig
from ..core import (
    BuildConfig, RangeSearchEngine, average_precision, exact_range_search, pack_labels,
)
from ..core.beam_search import ES_D_VISITED
from ..core.radius import default_grid, select_radius, sweep
from ..data.synthetic import make_corpus
from ..live import LiveConfig, LiveIndex
from ..serve import RangeServer, Request, ServerConfig
from ..utils import INVALID_ID, resolve_device


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def _radius(points, queries, metric, dev):
    """The paper's selection: a sweep over the default grid, robustness
    weight 0.2. Returns (r, grid index, profile)."""
    grid = default_grid(points, queries, metric, num=24)
    prof = sweep(points, queries, grid, metric, device=dev)
    r, gi = select_radius(prof, robustness_weight=0.2)
    print(f"[serve] selected radius {r:.4g} (zero-result frac {prof.zero_frac[gi]:.2f})")
    return r, gi, prof


def _replicated_main(args, dev) -> int:
    """Sharded/replicated traffic driver: host fan-out serving with R-way
    replication, hedged reads and scripted replica loss."""
    from ..core.build import build_vamana
    from ..core.graph import medoid
    from ..dist.sharded_engine import build_sharded
    from ..fault import FaultInjector, HedgePolicy, RetryPolicy

    n_shards = max(args.shards, 1)
    print(f"[serve] SHARDED corpus {args.profile} n={args.n} "
          f"shards={n_shards} replicas={args.replicas}")
    ds = make_corpus(args.profile, n=args.n, n_queries=args.queries)
    pts = np.asarray(ds.points, np.float32)
    qs = ds.queries
    r, _, _ = _radius(pts, qs, ds.metric, dev)

    bcfg = BuildConfig(max_degree=32, beam=64, metric=ds.metric)
    t0 = time.perf_counter()
    corpus = build_sharded(
        pts, n_shards, lambda p: (build_vamana(p, bcfg, device=dev), medoid(p).reshape(1)),
        corpus_dtype=args.corpus_dtype, tier=args.tier, resident_mb=args.resident_mb,
        device=dev)
    print(f"[serve] {n_shards}-shard index built in {time.perf_counter() - t0:.1f}s")
    if args.tier:
        print(f"[serve] tiered shards: {[t.budget().as_dict() for t in corpus.tiers]}")

    down = []
    if args.down_replicas:
        down = [tuple(int(x) for x in pair.split(":"))
                for pair in args.down_replicas.split(",")]
        print(f"[serve] scripted replica loss: {down}")
    injector = FaultInjector(seed=0, down_replicas=tuple(down)) if down else None
    hedge = HedgePolicy(delay_s=args.hedge_ms / 1e3) if args.hedge_ms > 0 else None

    rcfg = EngineDeployConfig().overrides(
        metric=ds.metric, beam=args.beam, max_beam=args.beam, visit_cap=512,
        expand_width=args.expand_width, corpus_dtype=args.corpus_dtype,
        mode=args.mode, result_cap=2048).range_cfg
    srv = RangeServer(None, rcfg, ServerConfig(max_batch=args.max_batch),
                      sharded=corpus, replicas=args.replicas, injector=injector,
                      hedge=hedge, retry=RetryPolicy(backoff_s=0.01))

    t0 = time.perf_counter()
    resp = []
    for i in range(args.queries):
        rq = Request(req_id=i, query=qs[i], radius=float(r))
        while srv.submit(rq) is not None:
            resp.extend(srv.step())
    resp.extend(srv.run_until_drained())
    dt = time.perf_counter() - t0

    gt_ids, _, gt_counts = exact_range_search(pts, qs, float(r), ds.metric, device=dev)
    res_ids = np.full((args.queries, 4096), 2**31 - 1, np.int64)
    counts = np.zeros(args.queries, np.int64)
    for rp in resp:
        k = min(len(rp.ids), 4096)
        res_ids[rp.req_id, :k] = rp.ids[:k]
        counts[rp.req_id] = k
    ap = average_precision(_np(gt_ids), _np(gt_counts), res_ids, counts)
    cov = min(rp.coverage for rp in resp)
    codes = {rp.code for rp in resp}
    print(f"[serve] {args.queries} queries in {dt:.3f}s = {args.queries / dt:.0f} QPS; "
          f"AP={ap:.4f}; min coverage={cov:.2f} codes={codes}")
    st = srv.stats
    print(f"[serve] replication: hedges_fired={st['hedges_fired']} "
          f"hedge_wins={st['hedge_wins']} breaker_trips={st['breaker_trips']} "
          f"replicas_lost={st['replicas_lost']} "
          f"replicas_recovered={st['replicas_recovered']} "
          f"shards_lost={st['shards_lost']} degraded_batches={st['degraded_batches']}")
    if args.tier:
        print(f"[serve] tier fetch path (shard 0): {corpus.tiers[0].counters.as_dict()}")
    return 0


def _labels_of(n: int, num_labels: int) -> list:
    """Synthetic per-point labels: 1-3 ids each from a small vocabulary."""
    lrng = np.random.default_rng(7)
    return [list(lrng.choice(num_labels, size=int(lrng.integers(1, 4)), replace=False))
            for _ in range(n)]


def _predicates(rng, args):
    """A slice of the traffic filters: mostly single-label AND lanes, every
    fourth a two-label OR; filtered and plain requests share micro-batches."""
    filt_of = [None] * args.queries
    fmode = ["and"] * args.queries
    if args.filter_frac > 0:
        nf = max(int(args.filter_frac * args.queries), 1)
        for qi in rng.choice(args.queries, nf, replace=False):
            if qi % 4 == 3:
                filt_of[qi] = [int(x) for x in rng.choice(args.num_labels, 2, replace=False)]
                fmode[qi] = "or"
            else:
                filt_of[qi] = [int(rng.integers(args.num_labels))]
        print(f"[serve] filtered traffic: {nf}/{args.queries} requests "
              f"carry label predicates")
    return filt_of, fmode


def _post_filter(gt_ids, gt_counts, filt_of, fmode, lab_of) -> tuple:
    """The POST-FILTERED oracle: each filtered lane's exact in-radius set
    restricted to the points matching its predicate (``lab_of(row)``: the
    row's label set)."""
    gt_ids, gt_counts = gt_ids.copy(), gt_counts.copy()
    for qi, pred in enumerate(filt_of):
        if pred is None:
            continue
        pred = set(pred)
        keep = [int(x) for x in gt_ids[qi][:gt_counts[qi]]
                if (pred <= lab_of(int(x)) if fmode[qi] == "and" else bool(pred & lab_of(int(x))))]
        gt_ids[qi] = INVALID_ID
        gt_ids[qi, :len(keep)] = keep
        gt_counts[qi] = len(keep)
    return gt_ids, gt_counts


def _churn_main(args, dev) -> int:
    """Live-engine traffic driver: interleaved insert/delete/query requests
    through one admission queue, AP scored on the final live set."""
    n, k = args.n, max(int(args.churn * args.n), 1)
    print(f"[serve] LIVE corpus {args.profile} n={n} churn={args.churn} "
          f"({k} inserts + {k} deletes interleaved with {args.queries} queries)")
    ds = make_corpus(args.profile, n=n + k, n_queries=args.queries)
    pts_all = np.asarray(ds.points, np.float32)
    init, stream = pts_all[:n], pts_all[n:]
    qs = ds.queries

    raw_labels = None
    if args.filter_frac > 0:
        # the full stream (initial corpus and future inserts) labeled up
        # front, so inserted points carry predicates the moment they land
        raw_labels = _labels_of(n + k, args.num_labels)
        print(f"[serve] labeled live corpus: {args.num_labels}-label "
              f"vocabulary, 1-3 labels/point (inserts carry labels)")
    r, _, _ = _radius(init, qs, ds.metric, dev)

    t0 = time.perf_counter()
    live = LiveIndex.create(
        init, LiveConfig(capacity=n + k, insert_batch=128),
        BuildConfig(max_degree=32, beam=64, metric=ds.metric),
        metric=ds.metric, corpus_dtype=args.corpus_dtype,
        labels=None if raw_labels is None else pack_labels(raw_labels[:n], args.num_labels),
        tier=args.tier, resident_mb=args.resident_mb, device=dev)
    print(f"[serve] live index built in {time.perf_counter() - t0:.1f}s {live.stats()}")
    if args.tier:
        print(f"[serve] tiered live corpus: {live.points.budget().as_dict()}")

    rcfg = EngineDeployConfig().overrides(
        metric=ds.metric, beam=args.beam, max_beam=args.beam, visit_cap=512,
        expand_width=args.expand_width, corpus_dtype=args.corpus_dtype,
        mode=args.mode, result_cap=2048).range_cfg
    srv = RangeServer(None, rcfg,
                      ServerConfig(max_batch=args.max_batch, continuous=args.continuous,
                                   lanes=args.lanes, slice_rounds=args.slice_rounds),
                      live=live)

    rng = np.random.default_rng(0)
    doomed = rng.choice(n, size=k, replace=False)  # initial ids to delete
    filt_of, fmode = _predicates(rng, args)
    reqs = (
        [Request(req_id=i, query=qs[i], radius=float(r),
                 filter_labels=filt_of[i], filter_mode=fmode[i])
         for i in range(args.queries)]
        + [Request(req_id=args.queries + i, op="insert", query=stream[i],
                   labels=None if raw_labels is None else np.asarray(raw_labels[n + i]))
           for i in range(k)]
        + [Request(req_id=args.queries + k + i, op="delete", delete_ids=np.asarray([doomed[i]]))
           for i in range(k)]
    )
    rng.shuffle(reqs)  # interleave mutations with query traffic
    t0 = time.perf_counter()
    resp = []
    for rq in reqs:
        while srv.submit(rq) is not None:  # queue_full: serve under
            resp.extend(srv.step())        # backpressure, then retry
    resp.extend(srv.run_until_drained())
    dt = time.perf_counter() - t0
    n_req = len(reqs)
    print(f"[serve] {n_req} requests ({args.queries} queries, {k} inserts, "
          f"{k} deletes) in {dt:.3f}s = {n_req / dt:.0f} req/s; "
          f"epoch={srv.stats['epoch']} consolidations={srv.stats['consolidations']}")

    # queries scored against the exact oracle on the FINAL live set (each was
    # answered at some intermediate epoch: the early/late disagreement of
    # shuffled traffic shows as a small AP haircut)
    ext, vecs = live.live_vectors()
    gt_ids, _, gt_counts = (_np(t) for t in exact_range_search(vecs, qs, float(r), ds.metric,
                                                               device=dev))
    if raw_labels is not None:
        # rows index vecs; labels key off external ids
        gt_ids, gt_counts = _post_filter(gt_ids, gt_counts, filt_of, fmode,
                                         lambda x: set(raw_labels[int(ext[x])]))
    lut = np.full(live.next_ext_id + 1, INVALID_ID, np.int64)
    lut[ext] = np.arange(len(ext))
    res_ids = np.full((args.queries, 4096), INVALID_ID, np.int64)
    counts = np.zeros(args.queries, np.int64)
    qresp = [rp for rp in resp if rp.op == "range"]
    for rp in qresp:
        rows = lut[np.minimum(rp.ids, live.next_ext_id)][:4096]
        res_ids[rp.req_id, :len(rows)] = rows
        counts[rp.req_id] = len(rows)
    ap = average_precision(gt_ids, gt_counts, res_ids, counts)
    lat = sorted(rp.latency_s for rp in qresp)
    print(f"[serve] AP vs final live set = {ap:.4f}; latency "
          f"p50={lat[len(lat) // 2] * 1e3:.1f}ms p99={lat[int(len(lat) * 0.99)] * 1e3:.1f}ms")
    print(f"[serve] stats={srv.stats}")
    if args.filter_frac > 0:
        st = srv.stats
        print(f"[serve] filtered: requests={st['filtered_requests']} "
              f"batches={st['filtered_batches']}/{st['batches']} (AP above scored vs the "
              f"post-filtered oracle on the final live set)")
    print(f"[serve] final live index: {live.stats()}")
    if args.tier:
        print(f"[serve] tier fetch path: {live.points.counters.as_dict()}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--profile", default="bigann-like")
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--queries", type=int, default=512)
    p.add_argument("--mode", default="greedy", choices=["beam", "doubling", "greedy"])
    p.add_argument("--beam", type=int, default=32)
    p.add_argument("--expand-width", type=int, default=4,
                   help="frontier nodes expanded per search iteration")
    p.add_argument("--corpus-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="corpus storage dtype: int8 runs the quantized two-pass "
                        "pipeline (guard-banded search + exact boundary rerank)")
    p.add_argument("--tier", action="store_true",
                   help="tiered corpus: keep only codes+meta on the device and serve "
                        "the guard-band rerank from a host-RAM raw-row store "
                        "(implies --corpus-dtype int8)")
    p.add_argument("--resident-mb", type=float, default=None,
                   help="device row-cache budget for --tier, in MB (default: n/8 rows)")
    p.add_argument("--early-stop", action="store_true")
    p.add_argument("--max-batch", type=int, default=128)
    p.add_argument("--mixed-radius", action="store_true",
                   help="per-request radii spread across the match distribution "
                        "instead of one shared radius")
    p.add_argument("--churn", type=float, default=0.0,
                   help="serve from a live index with this fraction of the corpus "
                        "inserted AND deleted during the run (interleaved with the "
                        "query traffic)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: saturated lanes ride a persistent pool "
                        "instead of lockstepping their micro-batch (greedy mode only)")
    p.add_argument("--lanes", type=int, default=32,
                   help="continuous-mode lane pool width (rounded to pow2)")
    p.add_argument("--slice-rounds", type=int, default=8,
                   help="greedy expansions per pooled lane per server step")
    p.add_argument("--effort", action="store_true",
                   help="fit an effort regressor on a workload sample and split "
                        "admissions into cheap/heavy dispatches")
    p.add_argument("--heavy-frac", type=float, default=0.0,
                   help="fraction of requests given a dense-region radius "
                        "(tail-latency workload)")
    p.add_argument("--filter-frac", type=float, default=0.0,
                   help="fraction of range requests carrying a label predicate (the "
                        "corpus gets synthetic per-point labels; AP is scored against "
                        "the post-filtered oracle)")
    p.add_argument("--num-labels", type=int, default=16,
                   help="synthetic label vocabulary size for --filter-frac")
    p.add_argument("--shards", type=int, default=0,
                   help="serve through the fault-tolerant host fan-out over this many "
                        "shards (0 = single frozen index)")
    p.add_argument("--replicas", type=int, default=1,
                   help="R-way shard replication (implies --shards serving; coverage "
                        "stays 1.0 under loss of R-1 replicas of any shard)")
    p.add_argument("--hedge-ms", type=float, default=0.0,
                   help="hedge delay in ms: fire the next replica when the primary is "
                        "slower than this (0 disables hedging)")
    p.add_argument("--down-replicas", default="",
                   help="scripted replica loss, e.g. '0:0,1:1' downs shard 0's replica "
                        "0 and shard 1's replica 1")
    p.add_argument("--device", default="cuda",
                   help="where the index lives and searches: the card by default, "
                        "'cpu' only when asked")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.tier:
        args.corpus_dtype = "int8"  # tiering exists for the quantized split

    if args.churn > 0:
        return _churn_main(args, dev)
    if args.shards > 0 or args.replicas > 1:
        return _replicated_main(args, dev)

    print(f"[serve] corpus {args.profile} n={args.n}")
    ds = make_corpus(args.profile, n=args.n, n_queries=args.queries)
    pts = np.asarray(ds.points, np.float32)
    qs = ds.queries
    r, gi, prof = _radius(pts, qs, ds.metric, dev)

    raw_labels = labels_packed = None
    if args.filter_frac > 0:
        # the category/attribute tags real filtered-search corpora carry
        raw_labels = _labels_of(args.n, args.num_labels)
        labels_packed = pack_labels(raw_labels, args.num_labels)
        print(f"[serve] labeled corpus: {args.num_labels}-label vocabulary, "
              f"1-3 labels/point")

    t0 = time.perf_counter()
    eng = RangeSearchEngine.build(
        pts, BuildConfig(max_degree=32, beam=64, metric=ds.metric), metric=ds.metric,
        corpus_dtype=args.corpus_dtype, labels=labels_packed, tier=args.tier,
        resident_mb=args.resident_mb, device=dev)
    print(f"[serve] index built in {time.perf_counter() - t0:.1f}s {eng.stats()}")
    if args.tier:
        bud = eng.points.budget()
        print(f"[serve] tiered corpus: device={bud.device_total} B "
              f"({bud.device_bytes_per_vector(args.n):.1f} B/vec) "
              f"host={bud.host_total} B; breakdown={bud.as_dict()}")

    rng = np.random.default_rng(0)
    if args.mixed_radius:
        # radii spread across the sweep grid around the selected radius:
        # tight (near-duplicate) through wide (recommendation) lanes mixed
        # in the same micro-batches
        lo = float(prof.radii[max(gi - 6, 0)])
        hi = float(prof.radii[min(gi + 4, len(prof.radii) - 1)])
        radii = np.linspace(lo, hi, args.queries).astype(np.float32)
        rng.shuffle(radii)
        print(f"[serve] mixed radii in [{lo:.4g}, {hi:.4g}]")
    else:
        radii = np.full(args.queries, r, np.float32)
    if args.heavy_frac > 0:
        # tail-latency workload: a slice of the traffic at the top of the
        # sweep grid (dense-region, phase-2-bound), the rest point-like
        hi = float(prof.radii[-1])
        nh = max(int(args.heavy_frac * args.queries), 1)
        radii[rng.choice(args.queries, nh, replace=False)] = hi
        print(f"[serve] heavy traffic: {nh} requests at radius {hi:.4g}")
    filt_of, fmode = _predicates(rng, args)

    rcfg = EngineDeployConfig().overrides(
        metric=ds.metric, beam=args.beam,
        max_beam=args.beam * (8 if args.mode == "doubling" else 1), visit_cap=512,
        es_metric=ES_D_VISITED if args.early_stop else 0, es_visit_limit=20,
        expand_width=args.expand_width, corpus_dtype=args.corpus_dtype,
        mode=args.mode, result_cap=2048).range_cfg
    effort = None
    if args.effort:
        # the admission regressor calibrated on exact match counts of a
        # sample of the workload (in production: observed counts)
        from ..models.effort import EffortPredictor
        samp = min(256, args.queries)
        _, _, c = exact_range_search(pts, qs[:samp], radii[:samp], ds.metric, device=dev)
        effort = EffortPredictor.fit(qs[:samp], radii[:samp], _np(c), device=dev)
        print(f"[serve] effort regressor fitted on {samp} samples")
    srv = RangeServer(eng, rcfg,
                      ServerConfig(max_batch=args.max_batch,
                                   es_radius_factor=1.5 if args.early_stop else 0.0,
                                   continuous=args.continuous, lanes=args.lanes,
                                   slice_rounds=args.slice_rounds),
                      effort=effort)
    t0 = time.perf_counter()
    resp = []
    for i in range(args.queries):
        rq = Request(req_id=i, query=qs[i], radius=float(radii[i]),
                     filter_labels=filt_of[i], filter_mode=fmode[i])
        while srv.submit(rq) is not None:  # queue_full: serve under
            resp.extend(srv.step())        # backpressure, then retry
    resp.extend(srv.run_until_drained())
    dt = time.perf_counter() - t0
    qps = args.queries / dt

    gt_ids, _, gt_counts = (_np(t) for t in exact_range_search(pts, qs, radii, ds.metric,
                                                               device=dev))
    if args.filter_frac > 0:
        lab_sets = [set(lab) for lab in raw_labels]
        gt_ids, gt_counts = _post_filter(gt_ids, gt_counts, filt_of, fmode,
                                         lambda x: lab_sets[x])
    res_ids = np.full((args.queries, 4096), 2**31 - 1, np.int64)
    counts = np.zeros(args.queries, np.int64)
    for rp in resp:
        k = min(len(rp.ids), 4096)
        res_ids[rp.req_id, :k] = rp.ids[:k]
        counts[rp.req_id] = k
    ap = average_precision(gt_ids, gt_counts, res_ids, counts)
    lat = sorted(rp.latency_s for rp in resp)
    print(f"[serve] {args.queries} queries in {dt:.3f}s = {qps:.0f} QPS (batched); AP={ap:.4f}")
    print(f"[serve] latency p50={lat[len(lat) // 2] * 1e3:.1f}ms "
          f"p99={lat[int(len(lat) * 0.99)] * 1e3:.1f}ms; stats={srv.stats}")
    hs = srv.latency_summary()
    print("[serve] histogram p50/p95/p99 (ms): "
          + " ".join(f"{op}={h['p50_ms']:.1f}/{h['p95_ms']:.1f}/{h['p99_ms']:.1f}"
                     for op, h in hs.items() if h["count"]))
    st = srv.stats
    if args.continuous:
        print(f"[serve] pool: admitted={st['pool_admitted']} oneshot={st['pool_oneshot']} "
              f"ticks={st['pool_ticks']} rotations={st['pool_rotations']} "
              f"buckets cheap/heavy={st['bucket_cheap']}/{st['bucket_heavy']}")
    if args.filter_frac > 0:
        print(f"[serve] filtered: requests={st['filtered_requests']} "
              f"batches={st['filtered_batches']}/{st['batches']} "
              f"(AP above scored vs the post-filtered oracle)")
    disp = srv.radius_dispersion()
    print(f"[serve] radius dispersion mean={disp['mean']:.4g} std={disp['std']:.4g} "
          f"range=[{disp['min']:.4g}, {disp['max']:.4g}] "
          f"mixed_batches={disp['mixed_radius_batches']}")
    if args.corpus_dtype == "int8":
        served = max(st["served"], 1)
        print(f"[serve] quantized corpus: {eng.stats()['hot_bytes_per_vector']} hot "
              f"bytes/vector (f32: {4 * ds.points.shape[1]}), "
              f"guard-band reranks/query={st['reranked'] / served:.2f}")
    if args.tier:
        print(f"[serve] tier fetch path: {eng.points.counters.as_dict()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
