"""``preprocess_ms.serve``: the detector's preprocessing on the card (the
program's span ``detect.preprocess``: float, /255, the hflip views, the
letterbox, the cast to the network's dtype), mean ms a chunk between its
CUDA events, over the traced run's chunks outside the profiled ones."""

from benchmark.harness import program


def read(ctx):
    return program.ms_per_chunk(ctx, ("detect.preprocess",))
