"""The training step's share of the card's bf16 peak (989 TFLOP/s, the
configuration's compute dtype), in %: three times the forward's matmul
and conv FLOPs (forward, and the backward's two products per product)
of the traced steps, over as many steps' time untraced (the steps of the
same batches, timed just before the traced window)."""

from benchmark import peaks


def read(ctx):
    if ctx.trace is None or not ctx.calls or not ctx.plain_s:
        return None
    frames = sum(c["rows"] * c["frames"] for c in ctx.calls)
    flops = 3.0 * frames * ctx.frame_flops()
    return 100.0 * flops / (len(ctx.calls) * ctx.plain_s
                            * peaks.PEAK_FLOPS[ctx.dtype])
