"""host_syncs_per_batch (syncs/batch): the program's blocking reads of the
device a batch, from its ``host_syncs`` counter, added where each read
happens (each search loop's test of its live lanes, the survivors' select,
the int8 guard band's select), over the traced batches run once more with
the cost hooks (``harness/counters.py``)."""

from rangebench.harness import counters

COUNTER = "host_syncs"
if counters.present():
    HOOK, OWNER = counters.HOOK, counters.OWNER


def launch_cost(args, kw, out):
    return counters.added(COUNTER, args, kw)


def read(ctx):
    return counters.per_batch(ctx, "host_syncs_per_batch")
