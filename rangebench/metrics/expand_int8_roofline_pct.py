"""expand_int8_roofline_pct (%): as ``expand_roofline_pct`` for the int8
expansion, whose kept rows cost d + 12 bytes each (codes and the 12-byte
metadata row)."""

from rangebench.harness import costs

HOOK = "repro_torch.kernels.expand.ops:expand_int8_cuda"
OWNER = "expand_int8"
META_BYTES = 12


def launch_cost(args, kw, out):
    codes, meta, neighbors, frontier, queries = args[:5]
    n_bytes, flops = costs.expand_cost(out[0], frontier, neighbors, queries,
                                       codes.shape[1] + META_BYTES)
    return costs.bound_s(n_bytes, flops)


def read(ctx):
    return costs.roofline(ctx, "expand_int8_roofline_pct", OWNER)
