"""Host milliseconds a step inside the program's ``emct.train.host_read``
span: the optimizer's read of the gradient norm, the host blocked until the
device has run everything the step launched before it."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(program_spans.host_s_in(t, "train.host_read"), t)
