"""K5's share of its roofline: the least time of the quantile-Huber loss and
its gradient at the step's ``[B, N]`` (``work.quantile_huber_bound_s``, from
the formula's arithmetic per pair, inputs read and outputs written once) over
the device time of the loss and its gradient a step.

That device time, read from the traced stretch that has the spans open
(``Readings.spanned``), is every device operation launched from inside the
trainer's call of the loss (``quantile_huber_loss`` as the QR-DQN trainer
calls it) and from inside the loss's backward (the autograd function's
``backward``), both under the span ``portbench.k5``, whatever source,
library or kind of operation it is.  Every kernel that ``quantile_huber.cu``
defines must have been launched from inside the span, and both entries must
have been found; otherwise the reader reads nothing."""

from portbench import devtrace, work

SPAN = "portbench.k5"
SPANS = {SPAN: ["reagent_tpu_torch.training.qrdqn_trainer:quantile_huber_loss",
                "reagent_tpu_torch.ops.quantile_huber:_QuantileHuberPerSample.backward"]}
SOURCE = "reagent_tpu_torch/ops/csrc/quantile_huber.cu"


def read(ctx):
    if ctx.spanned is None:
        return None
    under = devtrace.ops_under(ctx.spanned, SPAN)
    if (not under or "num_atoms" not in ctx.cfg or not all(ctx.found.get(e) for e in SPANS[SPAN])
            or not devtrace.all_inside(ctx.spanned, ctx.root / SOURCE, under)):
        return None
    per_step_s = sum(op.seconds for op in under) / ctx.spanned_work["steps"]
    bound_s, _ = work.quantile_huber_bound_s(int(ctx.traffic["minibatch"]), ctx.cfg["num_atoms"],
                                             ctx.peaks)
    return 100.0 * bound_s / per_step_s
