"""``launches_per_frame``: the device kernels of the profiled chunks over
their frames, an exact count."""


def read(ctx):
    t = ctx.trace
    if not t or not t.get("frames"):
        return None
    return t["kernels"] / t["frames"]
