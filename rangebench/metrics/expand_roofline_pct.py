"""expand_roofline_pct (%): the f32 frontier expansion's share of its
roofline over the traced batches: the sum of its launches' bounds
(``costs.expand_cost``: least bytes at the HBM rate, operations at the f32
rate) over the sum of their device times in the trace. The bounds come
from running the traced batches once more with this hook in place; where
that run's launches differ in number from the trace's, nothing is read."""

from rangebench.harness import costs

HOOK = "repro_torch.kernels.expand.ops:expand_cuda"
OWNER = "expand"


def launch_cost(args, kw, out):
    points, neighbors, frontier, queries = args[:4]
    n_bytes, flops = costs.expand_cost(out[0], frontier, neighbors, queries,
                                       points.shape[1] * points.element_size())
    return costs.bound_s(n_bytes, flops)


def read(ctx):
    return costs.roofline(ctx, "expand_roofline_pct", OWNER)
