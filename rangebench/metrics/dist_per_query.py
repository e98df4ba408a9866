"""dist_per_query (dists/query): the mean of ``RangeResult.n_dist`` over
every query the window answered: the distance computations of the walk
(and of the int8 guard band's rerank)."""


def read(ctx):
    if ctx.window.queries == 0:
        return None
    return ctx.sums["n_dist"] / ctx.window.queries
