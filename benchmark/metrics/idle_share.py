"""``idle_share``: the share of the profiled chunks' wall time in which
no device operation (kernel, copy or set) ran, in %."""


def read(ctx):
    t = ctx.trace
    if not t or not t.get("window_s"):
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
