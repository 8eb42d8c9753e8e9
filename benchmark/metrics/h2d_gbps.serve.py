"""``h2d_gbps.serve``: the bytes that the spans ``detect.upload`` and
``fuse.upload`` count over their device time (``h2d_ms.serve``'s), in
GB/s."""

from benchmark.harness import program


def read(ctx):
    return program.gbps(ctx, ("detect.upload", "fuse.upload"))
