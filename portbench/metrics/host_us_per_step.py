"""The host's own time a step: the mean length of the program's span
``reagent.loop.step`` (a step's draw, gather and train step as the host
dispatches them) less the time the loop's thread spent inside CUDA's
runtime and driver calls during it, in microseconds.  Those calls are left
out because a loop that the device paces waits inside its launches for room
in the queue: what remains is Python, torch's dispatch and the wrappers'
marshalling, the work that a lighter dispatch cuts.  From the stretch with
the host recorded (``Readings.spanned``), whose recording is itself host
work; nothing where the program opens no such span."""

from portbench import program_spans


def read(ctx):
    if ctx.spanned is None:
        return None
    return program_spans.own_host_us_per_interval(ctx.spanned, program_spans.STEP)
