"""The whole step's share of the card's f32 peak: the matrix-product FLOPs of
one update (``work.matmul_flops_per_step``, from the shapes) times the steps a
second of the same run's unprofiled window, over the published f32 rate.
Elementwise work, the loss (K5 among it) and the optimizer are not counted,
so this bounds what any kernel's roofline share can gain end to end."""

from portbench import work


def read(ctx):
    steps_per_s = ctx.per_s.get("steps")
    if not steps_per_s or "f32_flops" not in ctx.peaks:
        return None
    flops = work.matmul_flops_per_step(ctx.cfg, int(ctx.traffic["minibatch"]))
    return 100.0 * flops * steps_per_s / ctx.peaks["f32_flops"]
