"""The device time a step of building the minibatch: every device operation
launched inside the program's spans ``reagent.loop.sample`` (the draw of row
indices), ``reagent.loop.gather`` (the gather from the table) and
``reagent.fused_dqn.stage`` (the fused trainer's contiguous float32 layout
of the batch), in microseconds over the traced stretch's steps.  From the
stretch with the host recorded (``Readings.spanned``); nothing where the
program opens none of these spans."""

from portbench import program_spans

PROGRAM_SPANS = ("reagent.loop.sample", "reagent.loop.gather", "reagent.fused_dqn.stage")


def read(ctx):
    steps = program_spans.steps(ctx)
    under = program_spans.ops_under(ctx.spanned, PROGRAM_SPANS) if steps else None
    if under is None:
        return None
    return sum(op.seconds for op in under) * 1e6 / steps
