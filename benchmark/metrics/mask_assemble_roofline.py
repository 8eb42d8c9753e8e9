"""``mask_assemble_roofline``: K2's share of its roofline over the
profiled chunks: the least time for their operands
(``roofline.mask_bound``) over K2's device time in the trace
(``mask_kernel<0, ...>``), in %."""

from benchmark.harness import roofline
from benchmark.harness.trace import kernel_seconds


def read(ctx):
    seconds = kernel_seconds(ctx.trace, "mask_kernel<0")
    if not seconds or not ctx.mask_operands:
        return None
    bound_ms = sum(roofline.mask_bound(*ops, count=False)[0]
                   for ops in ctx.mask_operands)
    return bound_ms / (seconds * 1e3) * 100.0
