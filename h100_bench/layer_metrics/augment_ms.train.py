"""Device milliseconds a step of the operations launched inside the
program's ``emct.train.augment`` span (``train_step``'s dual-view
augmentation on the device)."""

from h100_bench import program_spans


def read(ctx):
    t = ctx.trace
    return program_spans.per_step_ms(program_spans.device_s_under(t, "train.augment"), t)
