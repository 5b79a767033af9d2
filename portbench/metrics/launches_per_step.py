"""Device operations (CUDA kernels, copies, memsets) a train step launches,
over a profiled stretch of whole calls.  An exact count: fewer launches a step
is what a loop-side change such as a CUDA graph shows first."""


def read(ctx):
    if not ctx.trace.device_ops or not ctx.profiled.get("steps"):
        return None
    return len(ctx.trace.device_ops) / ctx.profiled["steps"]
