"""Milliseconds a step in which the device ran nothing while the host was
inside the program's ``emct.train.step`` span and outside its
``emct.train.host_read``: the device waiting on the host's dispatch, the
restart after the read included."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(
        program_spans.idle_s_in(t, "train.step", outside="train.host_read"), t)
