"""walk_iters (iters/batch): walk iterations a batch, from the expand
wrappers' own ``.launches`` counters over the window: one launch an
iteration of either phase, each iteration ending in a host sync."""

COUNTS = ("repro_torch.kernels.expand.ops:expand_cuda",
          "repro_torch.kernels.expand.ops:expand_int8_cuda")


def read(ctx):
    launches = sum(ctx.launches[p] for p in COUNTS)
    if launches == 0 or ctx.window.batches == 0:
        return None
    return launches / ctx.window.batches
