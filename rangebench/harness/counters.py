"""Readings of the program's own counters (``repro_torch.trace.count``), a
batch at a time.

A counter's reader sets its cost hook (``HOOK``, ``cell.count_costs``) on
the program's ``trace.count``, which every call site names through its
module: while the traced batches run once more with the hooks in place,
the hook is handed every addition to every counter, and the reader's
``launch_cost`` keeps the additions to its own. So a reading is the
counter's additions over those batches (the cell's ``trace_batches``),
over their number. ``OWNER`` names no kernel: the trace finds no launch of
it, and the ``[trace]`` line's "summed bound" of such a reader is its
counter's total.

A program without ``repro_torch.trace`` (a version older than the
counters, which these benchmark files are also run against to compare)
gets no hook and its readers read nothing; nor does a run whose trace saw
no device work (a CPU run), since a counter of device syncs and
iterations means nothing there.
"""
from __future__ import annotations

import importlib.util

HOOK = "repro_torch.trace:count"
OWNER = "program_counter"


def present() -> bool:
    """Whether the program counts (has ``repro_torch.trace``)."""
    return importlib.util.find_spec("repro_torch.trace") is not None


def added(counter: str, args, kw) -> int:
    """What one ``trace.count(name, n=1)`` call added to ``counter``."""
    name = args[0] if args else kw["name"]
    if name != counter:
        return 0
    return int(args[1] if len(args) > 1 else kw.get("n", 1))


def per_batch(ctx, metric: str):
    """``metric``'s counter over the cost pass's batches, a batch; None
    where the pass did not run with its hook or saw no device work."""
    if ctx.trace is None or ctx.trace.busy_s <= 0 or metric not in ctx.costs:
        return None
    return ctx.costs[metric][1] / int(ctx.cell.settings["trace_batches"])
