"""One run of one cell: set-up, the measured window, the traced batches,
and the comparison with the plain reference.

Set-up (``setup_s``: process start to the first timed batch): the
configuration's corpus on the device; the program's exact k-NN graph
(``build_knn_graph``); the radius by the benchmark's own rule; the engine
(``RangeSearchEngine.from_graph``: start points and, for an int8 corpus,
the codes); the pool of query batches, the deployment's query set dealt
in the seed's order; ``warmup_batches`` batches through
the window's own call.

The window: pool batches back to back through ``engine.range(...,
compacted=True)``, each ending in ``torch.cuda.synchronize()``, until
``--seconds`` have passed; only whole batches count, and the window runs
from the first batch's start to the last batch's end. Each batch adds its
lanes' counters on the device, and keeps its judged lanes' answers off
the device: the first answer of each pool batch is copied into pinned
host buffers made in set-up, and every later one leaves only a digest
(``judge.digest``), read after the batch's synchronize; a later answer
whose digest differs from its batch's first is copied out whole. So the
device holds nothing of the harness's that grows with the window.

After it: the peak memory is read (the larger of set-up's and the
window's); with ``--trace 1`` a few more batches are traced
(``trace.py``) and run once more with the cost hooks of the per-layer
readers; then the program's state is freed and the reference judges
every answer the window gave (``judge.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import sys
import time
import types

import torch

from . import corpus, guard, judge, radius, trace, traffic
from .spec import Cell, reader

SUMMED = ("n_dist", "n_rerank", "n_visited", "phase2", "overflow", "count")
# the port's kernel wrappers, which name the kernels they launch; a
# roofline reader's OWNER joins them
KERNEL_OWNERS = ("expand", "expand_int8", "gatherdist", "gatherdist_int8", "rerank_fetch")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def resolve(path: str):
    """``"package.module:attr"`` to (module, attribute name)."""
    mod, attr = path.split(":")
    return importlib.import_module(mod), attr


@dataclasses.dataclass
class Setup:
    dist: corpus.Distribution
    n: int
    r: float
    engine: object
    rcfg: object
    pool: list              # traffic.Batch
    lanes: list             # judged lanes of each pool batch
    parts: dict             # set-up seconds by part
    hosts: list             # pinned host buffers of each pool batch's first answer


def range_config(cfg: dict):
    from repro_torch.core.beam_search import SearchConfig
    from repro_torch.core.range_search import RangeConfig
    search = SearchConfig(metric=cfg["metric"], corpus_dtype=cfg["corpus_dtype"],
                          **cfg["search"])
    return RangeConfig(search=search, **cfg["range"])


def judged_count(cell: Cell) -> int:
    """How many of the query set's queries are judged: ``check_lanes`` a
    batch of the pool on average."""
    st = cell.settings
    return int(st["pool_batches"]) * min(int(st["check_lanes"]), int(cell.mix["batch"]))


def build(cell: Cell, seed: int, dev: torch.device, t_start: float) -> Setup:
    from repro_torch.core import RangeSearchEngine, build_knn_graph
    cfg, st = cell.config, cell.settings
    parts = {"imports": time.perf_counter() - t_start}

    def lap(name, t0):
        sync(dev)
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    dist = corpus.distribution(cfg, dev)
    n = int(cfg["n"])
    points = corpus.corpus(dist, n)
    t = lap("corpus", t)
    idx = cfg["index"]
    if idx["kind"] != "knn":
        raise ValueError(f"unknown index kind {idx['kind']!r}")
    graph = build_knn_graph(points, k=int(idx["degree"]), metric=cfg["metric"], device=dev)
    t = lap("graph", t)
    rule = cfg["radius_rule"]
    sample = corpus.calibration_queries(dist, int(rule["sample"]), n)
    r, gi, zf = radius.choose(points, sample, rule, cfg["metric"])
    log(f"[setup] radius r={r!r} (grid index {gi}, zero-result fraction {zf:.4f} "
        f"on {sample.shape[0]} calibration queries)")
    t = lap("radius", t)
    engine = RangeSearchEngine.from_graph(
        points, graph, metric=cfg["metric"], n_starts=int(idx["n_starts"]),
        corpus_dtype=cfg["corpus_dtype"], device=dev)
    del points, graph
    t = lap("engine", t)
    pool, lanes, _ = traffic.pool(dist, cell.mix, n, r, int(st["pool_batches"]),
                                  judged_count(cell), seed)
    t = lap("pool", t)
    rcfg = range_config(cfg)
    for i in range(int(st["warmup_batches"])):
        b = pool[i % len(pool)]
        res = engine.range(b.queries, b.radii, cfg=rcfg, compacted=True)
    t = lap("warmup", t)
    pin = dev.type == "cuda"
    hosts = [judge.Answer(index=i,
                          ids=torch.empty((len(ln), res.ids.shape[1]), dtype=res.ids.dtype,
                                          pin_memory=pin),
                          dists=torch.empty((len(ln), res.dists.shape[1]),
                                            dtype=res.dists.dtype, pin_memory=pin),
                          count=torch.empty((len(ln),), dtype=res.count.dtype, pin_memory=pin))
             for i, ln in enumerate(lanes)]
    del res
    lap("host buffers", t)
    return Setup(dist=dist, n=n, r=r, engine=engine, rcfg=rcfg, pool=pool, lanes=lanes,
                 parts=parts, hosts=hosts)


def answer(setup: Setup, i: int):
    """Pool batch ``i`` through the window's call; returns the result."""
    b = setup.pool[i % len(setup.pool)]
    return setup.engine.range(b.queries, b.radii, cfg=setup.rcfg, compacted=True)


def keep(setup: Setup, i: int, res) -> judge.Answer:
    """The judged lanes of pool batch ``i``'s answer, where ``res`` is."""
    lanes = setup.lanes[i % len(setup.pool)]
    return judge.Answer(index=i % len(setup.pool), ids=res.ids[lanes],
                        dists=res.dists[lanes], count=res.count[lanes])


@dataclasses.dataclass
class Window:
    batches: int
    queries: int
    wall_s: float
    t0: float               # perf_counter at the first batch's start
    answers: list           # judge.Answer in host memory, each with its ``times``
    differed: int           # later answers that differed from their batch's first
    sums: dict              # SUMMED field -> total over every lane answered
    times: list             # each batch's seconds
    gc: list                # [collections, seconds] of the garbage collector in the window


def _gc_clock():
    """A callback that adds up the collector's runs and seconds."""
    tally, start = [0, 0.0], [0.0]

    def tick(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            tally[0] += 1
            tally[1] += time.perf_counter() - start[0]
    return tally, tick


def window(setup: Setup, seconds: float, dev: torch.device) -> Window:
    sums = {f: torch.zeros((), dtype=torch.int64, device=dev) for f in SUMMED}
    firsts: dict = {}       # pool index -> (host Answer, digest)
    odd, differed, queries, i = [], 0, 0, 0
    times = []
    tally, tick = _gc_clock()
    gc.callbacks.append(tick)
    try:
        sync(dev)
        t0 = time.perf_counter()
        while True:
            tb = time.perf_counter()
            res = answer(setup, i)
            j = i % len(setup.pool)
            kept = keep(setup, i, res)
            h = judge.digest(kept.ids, kept.dists, kept.count)
            if j not in firsts:
                host = setup.hosts[j]
                for f in ("ids", "dists", "count"):
                    getattr(host, f).copy_(getattr(kept, f), non_blocking=True)
            for f in SUMMED:
                sums[f] += getattr(res, f).sum(dtype=torch.int64)
            queries += int(res.count.shape[0])
            del res
            sync(dev)
            t1 = time.perf_counter()
            times.append(t1 - tb)
            h = int(h)
            if j not in firsts:
                firsts[j] = [setup.hosts[j], h]
            elif h == firsts[j][1]:
                firsts[j][0].times += 1
            else:
                differed += 1
                odd.append(kept.to("cpu"))
            del kept
            i += 1
            if t1 - t0 >= seconds:
                break
    finally:
        gc.callbacks.remove(tick)
    answers = [a for a, _ in firsts.values()] + odd
    return Window(batches=i, queries=queries, wall_s=t1 - t0, t0=t0, answers=answers,
                  differed=differed, sums={f: int(v) for f, v in sums.items()}, times=times,
                  gc=tally)


class _Recorder:
    """Stands in for a kernel wrapper while the costs are counted: calls
    it, hands each launch's arguments and outputs to ``record``, and reads
    and writes the wrapper's own counters (the wrapper counts through its
    module-level name)."""

    def __init__(self, inner, record):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "record", record)

    def __call__(self, *args, **kw):
        out = self.inner(*args, **kw)
        self.record(args, kw, out)
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        setattr(self.inner, name, value)


def count_costs(setup: Setup, steps, readers: dict, dev) -> dict:
    """Run the pool batches ``steps`` once more with every reader's cost
    hook in place; returns reader name -> (launches, summed bound seconds)."""
    hooked: dict = {}
    for name, mod in readers.items():
        if hasattr(mod, "HOOK"):
            hooked.setdefault(mod.HOOK, []).append(name)
    tallies = {name: [0, 0.0] for names in hooked.values() for name in names}
    saved = []
    for path, names in hooked.items():
        mod, attr = resolve(path)
        inner = getattr(mod, attr)

        def record(args, kw, out, names=names):
            for name in names:
                tallies[name][0] += 1
                tallies[name][1] += readers[name].launch_cost(args, kw, out)
        saved.append((mod, attr, inner))
        setattr(mod, attr, _Recorder(inner, record))
    try:
        for step in steps:
            answer(setup, step)
            sync(dev)
    finally:
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)
    return {name: tuple(v) for name, v in tallies.items()}


def launch_counts(paths) -> dict:
    out = {}
    for path in paths:
        mod, attr = resolve(path)
        out[path] = int(getattr(mod, attr).launches)
    return out


def reference_truths(cell: Cell, seed: int, r: float, n: int, dev, indices) -> tuple:
    """The corpus and each judged lane's queries, radii and |K|, all drawn
    again from the configuration and the seed: nothing the program made or
    held."""
    dist = corpus.distribution(cell.config, dev)
    points = corpus.corpus(dist, n)
    pool, lanes, _ = traffic.pool(dist, cell.mix, n, r, int(cell.settings["pool_batches"]),
                                  judged_count(cell), seed)
    want = {i: (pool[i].queries[lanes[i]], pool[i].radii[lanes[i]]) for i in indices}
    del pool
    return points, judge.truths_for(points, cell.config["metric"], want)


def free_program() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def peak_bytes(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def device_info(dev: torch.device, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def run(cell: Cell, seed: int, seconds: float, traced: bool, dev: torch.device,
        t_start: float) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    wanted = cell.per_layer if traced else cell.end_to_end
    readers = {m["name"]: reader(m["name"], cell.bench_dir) for m in wanted}
    counted = sorted({p for mod in readers.values() for p in getattr(mod, "COUNTS", ())})
    owners = tuple(sorted(set(KERNEL_OWNERS) | {mod.OWNER for mod in readers.values()
                                                if hasattr(mod, "OWNER")}))
    for path in counted:
        resolve(path)
    import repro_torch.core  # noqa: F401  (the program, imported before the guard)
    guard.check("after the imports")
    setup = build(cell, seed, dev, t_start)
    before = launch_counts(counted)
    peaks = [peak_bytes(dev)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win = window(setup, seconds, dev)
    after = launch_counts(counted)
    setup_s = win.t0 - t_start
    peaks.append(peak_bytes(dev))
    peak = max(peaks)
    log(f"[setup] {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.parts.items()))
    log(f"[window] {win.batches} batches, {win.queries} queries in {win.wall_s:.4f} s; "
        f"a batch " + " ".join(f"{t:.4f}" for t in win.times))
    log(f"[window] {len(win.answers)} distinct answers kept in host memory, "
        f"{win.differed} later answers differed from their batch's first; "
        f"garbage collector {win.gc[0]} runs, {win.gc[1]:.4f} s")
    log(f"[memory] peak allocated: set-up {peaks[0]}, window {peaks[1]} bytes")
    tr, costs = None, {}
    if traced:
        active = int(cell.settings["trace_batches"])
        tr = trace.traced(lambda step: (answer(setup, step), sync(dev)), active)
        log(f"[trace] {active} batches: {tr.window_s:.4f} s untraced, {tr.traced_s:.4f} s under "
            f"the device tracer, device busy {tr.busy_s:.4f} s")
        costs = count_costs(setup, range(1, active + 1), readers, dev)
        for name, (launches, bound) in costs.items():
            traced_n, dev_s = tr.owner_time(readers[name].OWNER, owners)
            log(f"[trace] {name}: {traced_n} launches traced in {dev_s:.6f} s, "
                f"{launches} counted, summed bound {bound:.6f} s")
    r, n = setup.r, setup.n
    indices = sorted({a.index for a in win.answers})
    setup.engine = None
    setup.pool = None
    free_program()
    t_ref = time.perf_counter()
    points, truths = reference_truths(cell, seed, r, n, dev, indices)
    verdict = judge.judge(points, cell.config["metric"], win.answers, truths,
                          cell.settings["limits"])
    log(f"[reference] {verdict.lanes} lanes judged ({verdict.distinct} distinct) in "
        f"{time.perf_counter() - t_ref:.3f} s")
    ctx = types.SimpleNamespace(
        cell=cell, setup_s=setup_s, setup_parts=setup.parts, window=win, verdict=verdict,
        launches={p: after[p] - before[p] for p in counted}, sums=win.sums, trace=tr,
        costs=costs, owners=owners)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    guard.check("after the window")
    out = {"correct": verdict.correct, "attempted": win.queries, "failed": verdict.failed,
           "metrics": metrics, "device": device_info(dev, peak)}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    out["checks"] = {name: {"value": v, "limit": verdict.limits[name]}
                     for name, v, _ in verdict.table()}
    return out
