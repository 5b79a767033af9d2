"""The share of the stretch traced on the device alone (``Readings.trace``)
in which the device stood idle inside a call's steps: its idle gaps
(``devtrace.idle_gaps``) less those at a call's edges, over the stretch's
length.  A call's edges are the gap from the stretch's start to its first
operation and each gap after a copy from the device to the host: the read
of a call's losses, which the loop itself never makes.  ``device_idle_pct``
less this share is the edges'.  Inside a call the idle time is the gaps
between the kernels a step launches, a microsecond or two each while the
host stays ahead, and any time the host falls behind: fewer launches a step
or a faster dispatch cut it.  With no host records in that stretch, the
host's cost of being recorded is not in it; nothing where the stretch holds
no operation or no copy to the host."""

import dataclasses

from portbench import devtrace, program_spans

READ = "Memcpy DtoH"  # the name the profiler gives a copy from the device to the host


def read(ctx):
    ops = program_spans.device_ops(ctx.trace)
    reads = {op.end_ns for op in ops if op.name.startswith(READ)}
    if not reads or ctx.trace.window_s <= 0:
        return None
    gaps = devtrace.idle_gaps(dataclasses.replace(ctx.trace, device_ops=ops))
    inside = sum(b - a for a, b in gaps if a != ctx.trace.start_ns and a not in reads)
    return 100.0 * inside * 1e-9 / ctx.trace.window_s
