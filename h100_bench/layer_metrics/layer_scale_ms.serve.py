"""Device milliseconds a call of the operations launched inside the
program's ``emct.layer_scale`` spans (in every DINOv2 block, twice: the
residual updates ``x + gamma * branch`` after the attention and after the
MLP)."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(program_spans.device_s_under(t, "layer_scale"), t)
