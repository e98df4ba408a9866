"""device_idle_pct (%): the share of the traced batches' wall time in which
no operation ran on the device: one minus the union of the device
intervals (never a sum of kernel times) of a trace of the device alone,
over the walls of the same batches run untraced, by the host's clock,
each from its first call to the end of its ``torch.cuda.synchronize()``
(``trace.py``)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
