"""The device's idle share of a training step, in %: 1 - (the union of its
kernel, copy and set intervals per step in the traced window) / the
seconds a step of the same work took untraced just before. (The
profiler stretches the traced window's host time; the device's own
intervals it leaves as they are.)"""


def read(ctx):
    if ctx.trace is None or not ctx.calls or not ctx.plain_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / len(ctx.calls) / ctx.plain_s)
