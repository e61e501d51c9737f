"""Device milliseconds per training step: the union of the device's
kernel, copy and set intervals in the traced window, per step. The
device's own time repeats from run to run far more closely than the
host's clock, so it shows a change to device work that the end-to-end
spread would hide."""


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    return 1e3 * ctx.trace.busy_s() / len(ctx.calls)
