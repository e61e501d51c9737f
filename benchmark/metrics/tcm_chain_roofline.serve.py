"""The squeezed-TCN chains' share of their roofline while serving, in %:
the least time of every TCN group of a forward at each call's (B, T),
over the device time of the kernels that run the groups as chains.

The groups (p, K, C, D, n branches) as ``flops.tcn_groups`` lists
them. Work of one group, counted once per input and output byte:
2 B T p (D C + n K C^2 + C D) FLOPs; x in and y out (2 B T D values)
and the weights p (D C + n K C^2 + C D + 9 C) in. Where no kernel runs
the groups as chains the metric is absent.
"""

from benchmark import peaks
from benchmark.flops import tcn_groups

KERNELS = ("tcm_chain_fwd",)


def work(b: int, t: int, group, dtype: str):
    p, k, c, d, n = group
    flops = 2.0 * b * t * p * (d * c + n * k * c * c + c * d)
    nbytes = peaks.BYTES[dtype] * (2 * b * t * d + p * (
        d * c + n * k * c * c + c * d + 9 * c))
    return flops, nbytes


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    spent = ctx.trace.device_seconds(KERNELS)
    if not spent:
        return None
    least = sum(peaks.least_seconds(*work(c["rows"], c["frames"], grp,
                                          ctx.dtype), ctx.dtype)
                for c in ctx.calls
                for grp in tcn_groups(ctx.config["model"]))
    return 100.0 * least / spent
