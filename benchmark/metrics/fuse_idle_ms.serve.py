"""``fuse_idle_ms.serve``: the card's idle time under the program's range
``fuse`` (``FusionPipeline.fuse``): per profiled chunk, the range's length
on the profiler's timeline less the union of device operations inside
it, in ms."""

from benchmark.harness import program


def read(ctx):
    return program.idle_ms_per_chunk(ctx, "fuse")
