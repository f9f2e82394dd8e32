"""Device milliseconds a call of the operations launched inside the
program's ``emct.swiglu`` spans (in every EVA block: the SwiGLU MLP, its
fc1_g, fc1_x and fc2 products, SiLU times the gate and the hidden
LayerNorm)."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(program_spans.device_s_under(t, "swiglu"), t)
