"""greedy_iters (iters/batch): the iterations of the greedy walk (phase 2
of ``mode="greedy"``, over the lanes whose beam filled with results) a
batch, from the program's ``walk.greedy_iters`` counter over the traced
batches run once more with the cost hooks (``harness/counters.py``). With
``walk_iters`` (both phases, from the expand launches) it splits the walk
into the paper's two phases."""

from rangebench.harness import counters

COUNTER = "walk.greedy_iters"
if counters.present():
    HOOK, OWNER = counters.HOOK, counters.OWNER


def launch_cost(args, kw, out):
    return counters.added(COUNTER, args, kw)


def read(ctx):
    return counters.per_batch(ctx, "greedy_iters")
