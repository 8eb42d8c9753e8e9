"""``inside_counts_roofline``: K1's share of its roofline over the
profiled chunks: the least time for their operands
(``roofline.k1_bound``) over K1's device time in the trace, in %."""

from benchmark.harness import roofline
from benchmark.harness.trace import kernel_seconds


def read(ctx):
    seconds = kernel_seconds(ctx.trace, "inside_counts_kernel")
    if not seconds or not ctx.k1_operands:
        return None
    bound_ms = sum(roofline.k1_bound(None, bits, None, mask)[2][0]
                   for bits, mask in ctx.k1_operands)
    return bound_ms / (seconds * 1e3) * 100.0
