"""Device milliseconds a step of the operations launched inside the
program's ``emct.train.loss`` span (the five-term loss of the training
forward)."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(program_spans.device_s_under(t, "train.loss"), t)
