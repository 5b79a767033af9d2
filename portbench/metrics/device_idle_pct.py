"""The share of the profiled stretch in which no operation ran on the device:
1 - (union of the device operations' intervals) / (the stretch's length),
both from the one trace."""


def read(ctx):
    if not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
