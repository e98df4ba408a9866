"""setup_s (s): process start to the first timed batch: imports, the
corpus, the k-NN graph, the radius, the engine, the query pool and the
warm-up (and, in a checkout's first run, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
