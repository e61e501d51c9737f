"""The LSTM-BF head's share of its roofline in a training step, in %:
the least time of the training forward and of the backward at each
step's (T, L = B x bins), in the step's compute dtype, over the device
time of the kernels that do that work.

Work, H = 64, rows = T x L, counted once per input and output byte:
- training forward: the three gate products, 2 x 3 x 64 x 256 FLOPs a
  row; xw1 (4H a row) in, the four state sequences (4 x H a row) out,
  the weights (192 x 256 + 256) in;
- backward: the gates recomputed (3 products), the three cotangent and
  the three weight-gradient products, 2 x 9 x 64 x 256 FLOPs a row;
  xw1, dy, the four states and dxw1 (256 + 64 + 256 + 256 a row), the
  weights in and their gradients out.
"""

from benchmark import peaks

KERNELS = ("lstm_bf_fwd", "lstm_bf_bwd", "lstm_bf_wgrad")
H = 64


def work(t: int, lanes: int, dtype: str):
    rows = t * lanes
    w = 3 * H * 4 * H + 4 * H
    size = peaks.BYTES[dtype]
    fwd = (2.0 * 3 * H * 4 * H * rows,
           size * (rows * (4 * H + 4 * H) + w))
    bwd = (2.0 * 9 * H * 4 * H * rows,
           size * (rows * (4 * H + H + 4 * H + 4 * H) + 2 * w))
    return fwd, bwd


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    spent = ctx.trace.device_seconds(KERNELS)
    if not spent:
        return None
    bins = ctx.config["stft"]["fft_num"] // 2 + 1
    least = sum(peaks.least_seconds(f, b, ctx.dtype)
                for c in ctx.calls
                for f, b in work(c["frames"], c["rows"] * bins, ctx.dtype))
    return 100.0 * least / spent
