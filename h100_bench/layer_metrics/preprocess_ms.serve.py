"""Device milliseconds a call of the operations launched inside the
program's ``emct.serve.preprocess`` span (the batch's copy to the device and
the eval views)."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(program_spans.device_s_under(t, "serve.preprocess"), t)
