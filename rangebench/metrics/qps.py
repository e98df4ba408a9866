"""qps (queries/s): every query the window answered over the window's
wall time, from the first batch's start to the last batch's end. Batches
run back to back, each ending in ``torch.cuda.synchronize()``, and only
whole batches count."""


def read(ctx):
    return ctx.window.queries / ctx.window.wall_s
