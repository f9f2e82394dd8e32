"""The hand-written kernels' least time over their measured device time in
the profiled stretch: the sum over every launch of its bound (``kernel_work/``,
from the cell's shapes) over the sum of the device time of the kernels whose
names match."""


def read(ctx):
    bound, measured = 0.0, 0.0
    for work in ctx.kernel_work:
        seconds, count = ctx.trace.device_s_matching(work.module.SYMBOLS)
        if count == 0:
            continue
        bound += work.bound_s_per_step * ctx.trace.steps
        measured += seconds
    if measured == 0.0:
        return None
    return 100.0 * bound / measured
