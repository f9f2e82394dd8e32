"""The share of the profiled stretch in which no operation ran on the
device: 100 (1 - busy / stretch), busy the union of the device's kernel,
copy and memset intervals."""


def read(ctx):
    t = ctx.trace
    if not t.busy_intervals:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
