"""Device milliseconds a step of the operations launched under the
optimizer's span (the train state's ``optimizer.step``)."""


def read(ctx):
    s = ctx.trace.device_s_under("optimizer")
    return None if not s else 1e3 * s / ctx.trace.steps
