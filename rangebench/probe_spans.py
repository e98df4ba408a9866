"""The program's spans and counters on one cell, beside the trace's passes.

    python3 rangebench/probe_spans.py --workload <cell> --seed <n> [--repeat k]
        [--sync-sites]

In one process, the cell's set-up (``cell.build``), then over the cell's
``trace_batches`` pool batches (steps 1.., as the traced batches of a run):

- results: pool batch 0 answered with spans off and with spans on, every
  field compared bit for bit and ``judge.digest`` of each;
- passes 0-2 of a traced run, ``trace.traced``, spans off: the untraced
  wall (pass 0) and the device's busy time (pass 1);
- pass (a), ``spans.span_pass``: spans on, no profiler; ``[spans] name
  count total_ms self_ms`` a span name, and the counters' additions;
- pass (b), ``spans.attribution_pass``: host and device under the
  profiler, spans on; ``[device] name busy_ms own_ms`` a span name (device
  busy time launched inside the span, and inside it but no child), the
  links used, and ``[trace] idle by span``;
- the three run ``--repeat`` times in turns, each time giving the five
  readings of ``spans.readings``; the spans' cost is the median wall of
  (a) over the median wall of pass 0, and the device time pass (b)
  attributes is checked against pass 1's busy time;
- with ``--sync-sites``, on a card: one batch under
  ``repro_torch.trace.card_syncs``, each synchronizing call's innermost
  frame in the program (``[sync] count file:line function``), against the
  ``host_syncs`` counter's additions over the same batch.

The last line of standard output is one JSON object of the numbers. No run
of the benchmark runs this; its readings are in ``PERF.md``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _card_line, _paths  # noqa: E402


def probe(c, seed: int, dev, t_start: float, sites: bool = False, repeat: int = 1) -> dict:
    """The numbers of one cell ``c`` (``spec.Cell``) at ``seed`` on ``dev``."""
    import torch

    from rangebench.harness import cell as cells
    from rangebench.harness import judge, spans, trace as passes
    from repro_torch import trace
    setup = cells.build(c, seed, dev, t_start)
    active = int(c.settings["trace_batches"])
    steps = range(1, active + 1)

    def run_batch(step):
        cells.answer(setup, step)
        cells.sync(dev)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    out = {"cell": c.name, "seed": seed, "batches": active}
    # spans change no bit of a result
    off = cells.answer(setup, 0)
    with trace.tracing():
        on = cells.answer(setup, 0)
    trace.reset()
    out["bitwise"] = all(torch.equal(bits(getattr(off, f)), bits(getattr(on, f)))
                         for f in vars(off))
    out["digest"] = [int(judge.digest(r.ids, r.dists, r.count)) for r in (off, on)]
    del off, on
    cells.log(f"[probe] spans off/on: bitwise {out['bitwise']}, digests {out['digest']}")

    for key in ("pass0_s", "busy_s", "attributed_busy_s", "pass_a_s", "repeats"):
        out[key] = []
    for _ in range(repeat):
        tr = passes.traced(run_batch, active)
        out["pass0_s"].append(tr.window_s)
        out["busy_s"].append(tr.busy_s)
        t = time.perf_counter()
        wall_a, summ, counted = spans.span_pass(run_batch, steps)
        out["pass_a_s"].append(wall_a)
        out["pass_a_took_s"] = time.perf_counter() - t
        t = time.perf_counter()
        attr = spans.attribution_pass(run_batch, active)
        out["pass_b_took_s"] = time.perf_counter() - t
        out["attributed_busy_s"].append(
            passes.busy([(None, s, e) for s, e, _ in attr.intervals]))
        out["repeats"].append(spans.readings(summ, counted, attr, active))
    out["span_cost_pct"] = 100.0 * (statistics.median(out["pass_a_s"])
                                    / statistics.median(out["pass0_s"]) - 1.0)
    out["spans_per_batch"] = sum(n for n, _, _ in summ.values()) / active
    for name, (n, tot, own) in sorted(summ.items(), key=lambda kv: -kv[1][1]):
        cells.log(f"[spans] {name} {n} {tot / 1e6:.3f} {own / 1e6:.3f}")
    out["counters_per_batch"] = {k: v / active for k, v in sorted(counted.items())}
    for name, (inside, own) in attr.busy_by_span().items():
        cells.log(f"[device] {name} {1e3 * inside:.3f} {1e3 * own:.3f}")
    cells.log(f"[device] links: {attr.linked}")
    idle = sorted(attr.idle.items(), key=lambda kv: -kv[1])
    cells.log("[trace] idle by span " + " ".join(f"{n}={s:.4f}" for n, s in idle))
    out["idle_by_span_s"] = dict(idle)
    out["links"] = attr.linked
    if sites and dev.type == "cuda":
        before = trace.counters().get("host_syncs", 0)
        frames = trace.card_syncs(lambda: cells.answer(setup, 1))
        out["host_syncs_counted"] = trace.counters().get("host_syncs", 0) - before
        out["sync_sites"] = {}
        for f in frames:
            key = (f"{f.filename.split('/src/')[-1]}:{f.lineno} {f.name}" if f
                   else "outside the program")
            out["sync_sites"][key] = out["sync_sites"].get(key, 0) + 1
        for k, v in sorted(out["sync_sites"].items(), key=lambda kv: -kv[1]):
            cells.log(f"[sync] {v} {k}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--sync-sites", action="store_true")
    args = ap.parse_args(argv)
    _paths()
    import torch

    from rangebench.harness import spec
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    out = probe(spec.load(ROOT, args.workload), args.seed, dev, T_START, args.sync_sites,
                args.repeat)
    out["card"] = _card_line() if dev.type == "cuda" else "cpu"
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
