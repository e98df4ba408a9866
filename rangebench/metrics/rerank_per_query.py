"""rerank_per_query (pairs/query): the mean of ``RangeResult.n_rerank``
over every query the window answered: the guard band's exact reranks of an
int8 corpus. Nothing to read on another corpus."""


def read(ctx):
    if ctx.cell.config["corpus_dtype"] != "int8" or ctx.window.queries == 0:
        return None
    return ctx.sums["n_rerank"] / ctx.window.queries
