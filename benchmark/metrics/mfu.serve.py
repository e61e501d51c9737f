"""The serving call's share of the card's float32 peak (67 TFLOP/s,
outside the tensor cores: the configuration serves in float32 with TF32
off), in %: the model's matmul and conv FLOPs over the items' own
(unpadded) frames of the traced calls, over as many calls' time untraced
(the calls of the same batches, timed just before the traced window)."""

from benchmark import peaks


def read(ctx):
    if ctx.trace is None or not ctx.calls or not ctx.plain_s:
        return None
    frames = sum(c["useful_frames"] for c in ctx.calls)
    flops = frames * ctx.frame_flops()
    return 100.0 * flops / (len(ctx.calls) * ctx.plain_s
                            * peaks.PEAK_FLOPS[ctx.dtype])
