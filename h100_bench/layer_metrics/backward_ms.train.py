"""Device milliseconds a step of the operations launched inside the
program's ``emct.train.backward`` span (``zero_grad`` and ``loss.backward()``,
launches from the autograd thread included; under block remat the
recomputed forward too)."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(program_spans.device_s_under(t, "train.backward"), t)
