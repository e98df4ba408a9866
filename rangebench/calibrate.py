"""The readings the comparison's limits are set from, at a cell's own size.

    python3 rangebench/calibrate.py --workload <cell> --seeds 11,12,13 [--controls 3]
        [--draws 0,1,2,3]

In one process: for each draw (a ``distribution_seed`` put in place of the
configuration's; by default the configuration's own), the cell's set-up
once (the corpus, graph and radius of that draw), then for each seed its
pool, every batch of it answered once through the window's call, and the
reference's truth. Printed, one JSON line a draw and seed, the readings
(``judge.NUMBERS`` and ``ap``) of:

- ``program``: the program's answers, as a run judges them;
- ``half``: the same answers with the second half of each batch left
  out (its lanes answer nothing): the fault ``ap`` has to catch;
- ``altered``: the same answers with each answering lane's first id
  replaced by the next corpus id: an answer altered where it is produced;
- ``lowered``: the same answers with every reported distance one radius
  too low: a distance altered where it is produced (what ``dist_under``
  has to catch where a corpus reports lower bounds);
- ``no_rerank`` (int8 corpora): the program's own path without the guard
  band's rerank (``RangeConfig.rerank=False``), which returns the
  certified superset;
- ``control`` (the first ``--controls`` seeds of each draw): the
  reference in the precision below the corpus dtype's
  (``reference.control_of``) in the program's place, on the same lanes.

No run of the benchmark runs this; its readings and the limits set from
them are in ``PERF.md``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _paths  # noqa: E402


def faults(setup, answers):
    """The half-batch, altered-answer and lowered-distance versions of the
    program's answers."""
    import torch
    from rangebench.harness import judge
    half, altered, lowered = [], [], []
    for a in answers:
        size = setup.pool[a.index].queries.shape[0]
        lanes = setup.lanes[a.index]
        gone = lanes >= size // 2
        half.append(judge.Answer(index=a.index,
                                 ids=torch.where(gone[:, None], -1, a.ids),
                                 dists=torch.where(gone[:, None], torch.inf, a.dists),
                                 count=torch.where(gone, 0, a.count)))
        ids = a.ids.clone()
        has = a.count > 0
        ids[has, 0] = (ids[has, 0] + 1) % setup.n
        altered.append(dataclasses.replace(a, ids=ids))
        radii = setup.pool[a.index].radii[lanes]
        lowered.append(dataclasses.replace(a, dists=a.dists - radii.abs()[:, None]))
    return {"half": half, "altered": altered, "lowered": lowered}


def readings(c, setup, points, seed: int, dev, control: bool) -> dict:
    """One seed's readings of every variant (see the module's docstring),
    on a built ``setup``: the corpus, its graph and the radius are the
    configuration's, the same for every seed, so one set-up serves them
    all; the seed deals the pool."""
    from rangebench.harness import cell as cells
    from rangebench.harness import judge, reference, traffic
    cfg, lim = c.config, c.settings["limits"]
    t0 = time.perf_counter()
    setup.pool, setup.lanes, _ = traffic.pool(
        setup.dist, c.mix, setup.n, setup.r, int(c.settings["pool_batches"]),
        cells.judged_count(c), seed)
    variants = {"program": [cells.keep(setup, i, cells.answer(setup, i))
                            for i in range(len(setup.pool))]}
    variants.update(faults(setup, variants["program"]))
    if cfg["corpus_dtype"] == "int8":
        rc = dataclasses.replace(setup.rcfg, rerank=False)
        variants["no_rerank"] = [
            cells.keep(setup, i, setup.engine.range(b.queries, b.radii, cfg=rc,
                                                    compacted=True))
            for i, b in enumerate(setup.pool)]
    cells.sync(dev)
    truths = judge.truths_for(points, cfg["metric"], {
        i: (b.queries[setup.lanes[i]], b.radii[setup.lanes[i]])
        for i, b in enumerate(setup.pool)})
    if control:
        variants["control"] = []
        for i, t in truths.items():
            ids, dists, cnt = reference.control(reference.control_of(cfg["corpus_dtype"]),
                                                points, t.queries, t.radii,
                                                cfg["range"]["result_cap"], cfg["metric"])
            variants["control"].append(judge.Answer(index=i, ids=ids, dists=dists, count=cnt))
    line = {"workload": c.name, "draw": cfg["generator"]["distribution_seed"], "seed": seed,
            "r": setup.r}
    for name, answers in variants.items():
        v = judge.judge(points, cfg["metric"], answers, truths, lim)
        line[name] = dict(v.readings, failed=v.failed, lanes=v.lanes, correct=v.correct)
    line["seconds"] = time.perf_counter() - t0
    return line


def calibrate(c, seeds, controls: int, dev, t_start: float):
    """Yield each seed's readings; one set-up for all of them."""
    from rangebench.harness import cell as cells
    from rangebench.harness import corpus
    setup = cells.build(c, seeds[0], dev, t_start)
    points = corpus.corpus(setup.dist, setup.n)   # the reference's own draw
    for k, seed in enumerate(seeds):
        yield readings(c, setup, points, seed, dev, k < controls)


def redrawn(c, draw: int):
    """The cell ``c`` on another draw of its configuration's distribution."""
    cfg = json.loads(json.dumps(c.config))
    cfg["generator"]["distribution_seed"] = draw
    return dataclasses.replace(c, config=cfg)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--draws", default="", help="comma-separated distribution seeds")
    args = ap.parse_args()
    _paths()
    import torch
    from rangebench.harness import spec
    c = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    draws = [int(d) for d in args.draws.split(",")] if args.draws else [
        c.config["generator"]["distribution_seed"]]
    t_start = T_START
    for draw in draws:
        for line in calibrate(redrawn(c, draw), seeds, args.controls, dev, t_start):
            print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
