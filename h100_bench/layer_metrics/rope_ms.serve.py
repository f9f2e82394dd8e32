"""Device milliseconds a call of the operations launched inside the
program's ``emct.rope`` spans (in every EVA block: the rotary embedding of q
and k and their write, beside v, into the attention kernels' layout)."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(program_spans.device_s_under(t, "rope"), t)
