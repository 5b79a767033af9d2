"""K1's share of its roofline: the least time of one fused DQN update
(``work.fused_update_bound_s``: its matrix-product FLOPs over the f32 peak, or
its bytes over the HBM rate) over the device time of the update a step.

That device time, read from the traced stretch that has the spans open
(``Readings.spanned``), is every device operation launched from inside the
trainer's call of the fused update (the span ``portbench.k1`` around the
trainer's ``_update``), whatever source, library or kind of operation it
is, so work that a redesign moves into another kernel file, a library call
or a torch op stays counted.  Every kernel that ``fused_dqn.cu`` defines
must have been launched from inside that span; where one was not, or the
span saw nothing, the update is not where this reader looks and it reads
nothing."""

from portbench import devtrace, work

SPAN = "portbench.k1"
SPANS = {SPAN: ["program:trainer._update"]}
SOURCE = "reagent_tpu_torch/ops/csrc/fused_dqn.cu"


def read(ctx):
    if ctx.spanned is None:
        return None
    under = devtrace.ops_under(ctx.spanned, SPAN)
    if not under or not devtrace.all_inside(ctx.spanned, ctx.root / SOURCE, under):
        return None
    per_update_s = sum(op.seconds for op in under) / ctx.spanned_work["steps"]
    bound_s, _ = work.fused_update_bound_s(ctx.cfg, int(ctx.traffic["minibatch"]), ctx.peaks)
    return 100.0 * bound_s / per_update_s
