"""``network_ms.serve``: the YOLO11-seg network (the program's span
``detect.network``), mean ms a chunk between its CUDA events, over the
traced run's chunks outside the profiled ones."""

from benchmark.harness import program


def read(ctx):
    return program.ms_per_chunk(ctx, ("detect.network",))
