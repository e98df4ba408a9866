"""rerank_fetch_roofline_pct (%): the guard band's exact rerank against its
roofline over the traced batches: ``costs.rerank_cost``'s bound (each
distinct f32 row and query once, each pair's id, lane and distance) over
``rerank_fetch``'s device time in the trace."""

from rangebench.harness import costs

HOOK = "repro_torch.kernels.rerank_fetch.ops:rerank_fetch_cuda"
OWNER = "rerank_fetch"


def launch_cost(args, kw, out):
    raw, queries, ids, lanes = args[:4]
    n_bytes, flops = costs.rerank_cost(ids, lanes, raw.shape[1])
    return costs.bound_s(n_bytes, flops)


def read(ctx):
    return costs.roofline(ctx, "rerank_fetch_roofline_pct", OWNER)
