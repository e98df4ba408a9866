"""ap (ratio): the paper's size-weighted average precision (Def. 2.2),
sum |K ∩ K'| / sum |K|, over every distinct query judged (the window's
judged lanes of every batch; ``judge.py``), against the exact answers of
the benchmark's float64 reference."""


def read(ctx):
    return ctx.verdict.readings["ap"]
