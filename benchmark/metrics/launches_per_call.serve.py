"""The host's kernel launch calls per enhance call in the traced window
(the profiler's runtime events: cudaLaunchKernel, cuLaunchKernel and
their cooperative, Ex and graph forms)."""


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    return ctx.trace.launches / len(ctx.calls)
