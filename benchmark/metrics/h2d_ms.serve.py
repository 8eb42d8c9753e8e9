"""``h2d_ms.serve``: the copies of a chunk's frames and scans to the card,
the program's spans ``detect.upload`` (``YoloDetector.forward``) and
``fuse.upload`` (``FusionPipeline.fuse``), mean ms a chunk between each
span's CUDA events, over the traced run's chunks outside the profiled
ones."""

from benchmark.harness import program


def read(ctx):
    return program.ms_per_chunk(ctx, ("detect.upload", "fuse.upload"))
