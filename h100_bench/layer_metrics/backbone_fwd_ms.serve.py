"""Device milliseconds a batch or step of the operations launched under the
backbone's span (``model.backbone.backbone``'s forward)."""


def read(ctx):
    s = ctx.trace.device_s_under("backbone")
    return None if not s else 1e3 * s / ctx.trace.steps
