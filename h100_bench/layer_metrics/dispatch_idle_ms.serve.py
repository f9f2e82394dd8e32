"""Milliseconds a call in which the device ran nothing while the host was
inside the program's ``emct.serve.infer`` span: the device waiting on the
host's dispatch (the caller's read of the logits lies outside the span)."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(program_spans.idle_s_in(t, "serve.infer"), t)
