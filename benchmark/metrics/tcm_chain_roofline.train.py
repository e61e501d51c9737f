"""The squeezed-TCN chains' share of their roofline in a training step,
in %: the least time of every TCN group's forward and backward at each
step's (B, T), in the step's compute dtype, over the device time of the
kernels that run the groups as chains (forward, backward walk, weight
gradients and their sum).

Groups as ``flops.tcn_groups`` lists them. Work of one group, counted
once per input and output byte, F = 2 B T p (D C + n K C^2 + C D):
- forward: F FLOPs; x in, y out, the weights W = p (D C + n K C^2 + C D
  + 9 C) in;
- backward: the forward recomputed and two products per product, 3 F
  FLOPs; x and dy in, dx out (3 B T D values), the weights in and their
  gradients out (2 W).
Where no kernel runs the groups as chains the metric is absent.
"""

from benchmark import peaks
from benchmark.flops import tcn_groups

KERNELS = ("tcm_chain_fwd", "tcm_chain_bwd", "tcm_chain_wgrad",
           "tcm_chain_grad_sum")


def work(b: int, t: int, group, dtype: str):
    p, k, c, d, n = group
    f = 2.0 * b * t * p * (d * c + n * k * c * c + c * d)
    w = p * (d * c + n * k * c * c + c * d + 9 * c)
    size = peaks.BYTES[dtype]
    return ((f, size * (2 * b * t * d + w)),
            (3 * f, size * (3 * b * t * d + 2 * w)))


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    spent = ctx.trace.device_seconds(KERNELS)
    if not spent:
        return None
    least = sum(peaks.least_seconds(f, nb, ctx.dtype)
                for c in ctx.calls
                for grp in tcn_groups(ctx.config["model"])
                for f, nb in work(c["rows"], c["frames"], grp, ctx.dtype))
    return 100.0 * least / spent
