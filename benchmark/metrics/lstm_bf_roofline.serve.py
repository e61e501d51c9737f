"""The LSTM-BF forward's share of its roofline while serving, in %: the
least time of the head's two stacked LSTMs over each call's (T, L = B x
bins) lanes, over the device time of the kernels that do that work.

Work of one forward at (T, L), H = 64 (counted once per input and output
byte): the recurrent and layer-2 products, 2 (64 x 256 + 128 x 256) FLOPs
per lane and step; the hoisted layer-1 projection xw1 (T, L, 4H) in, h2
(T, L, H) out, the weights (192 x 256 + 256) in, in the call's dtype.
"""

from benchmark import peaks

KERNELS = ("lstm_bf_fwd",)
H = 64


def work(t: int, lanes: int, dtype: str):
    flops = 2.0 * (H * 4 * H + 2 * H * 4 * H) * lanes * t
    nbytes = peaks.BYTES[dtype] * (t * lanes * 4 * H + t * lanes * H
                                   + 3 * H * 4 * H + 4 * H)
    return flops, nbytes


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    spent = ctx.trace.device_seconds(KERNELS)
    if not spent:
        return None
    bins = ctx.config["stft"]["fft_num"] // 2 + 1
    least = sum(peaks.least_seconds(*work(c["frames"], c["rows"] * bins,
                                          ctx.dtype), ctx.dtype)
                for c in ctx.calls)
    return 100.0 * least / spent
