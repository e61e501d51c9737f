"""Device milliseconds per training step of the ``torch._foreach_*``
kernels: the global-norm clip's scaling, Adam's moments and update, and
the update's addition to the parameters (``multi_tensor_apply``)."""

KERNELS = ("multi_tensor_apply",)


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    s = ctx.trace.device_seconds(KERNELS)
    return None if s is None else 1e3 * s / len(ctx.calls)
