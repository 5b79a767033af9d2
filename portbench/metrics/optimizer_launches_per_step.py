"""Device operations a step launched by the optimizer: those launched inside
the program's spans ``reagent.optim.update`` (every update rule's step) and
``reagent.optim.soft_update`` (the target network's Polyak average), over
the traced stretch's steps.  An exact count, from the stretch with the host
recorded (``Readings.spanned``); nothing where the program opens neither
span."""

from portbench import program_spans

PROGRAM_SPANS = ("reagent.optim.update", "reagent.optim.soft_update")


def read(ctx):
    steps = program_spans.steps(ctx)
    under = program_spans.ops_under(ctx.spanned, PROGRAM_SPANS) if steps else None
    if under is None:
        return None
    return len(under) / steps
