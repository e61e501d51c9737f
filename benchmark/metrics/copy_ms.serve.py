"""Device milliseconds of host-to-device and device-to-host copies per
enhance call in the traced window."""

KERNELS = ("Memcpy HtoD", "Memcpy DtoH")


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    s = ctx.trace.device_seconds(KERNELS)
    return None if s is None else 1e3 * s / len(ctx.calls)
