"""Model FLOPs (``flops/``) of the timed window's batches or steps over its
length on the host clock, as a share of 989 TFLOP/s (bf16 dense, H100 SXM)."""

PEAK_FLOPS = 989e12


def read(ctx):
    if ctx.window_steps == 0 or ctx.device_type != "cuda":
        return None
    return 100.0 * ctx.flops_per_step * ctx.window_steps / ctx.window_s / PEAK_FLOPS
