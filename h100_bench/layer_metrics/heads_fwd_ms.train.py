"""Device milliseconds a batch or step of the operations launched under the
GPF, moment-head and classifier spans (their forwards)."""


def read(ctx):
    parts = [ctx.trace.device_s_under(s) for s in ("gpf", "moment_head", "classifier")]
    total = sum(p for p in parts if p)
    return None if not total else 1e3 * total / ctx.trace.steps
