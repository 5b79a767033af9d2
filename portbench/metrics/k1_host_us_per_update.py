"""The host's own time inside K1's wrapper an update: the mean length of the
program's span ``reagent.k1`` (``ops.fused_dqn_offline``'s CUDA route: the
marshalling of the C entry's arguments and its launches) less the time
spent inside CUDA's runtime and driver calls during it, where a loop that
the device paces waits for room in the launch queue; in microseconds, in
the stretch with the host recorded (``Readings.spanned``).  Nothing where
the program opens no such span."""

from portbench import program_spans


def read(ctx):
    if ctx.spanned is None:
        return None
    return program_spans.own_host_us_per_interval(ctx.spanned, "reagent.k1")
