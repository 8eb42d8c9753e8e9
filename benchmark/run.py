"""Run one cell of the benchmark on the card and print its result line.

    python benchmark/run.py --workload x_headline_b64 --seed 7 \
        --seconds 30 --trace 0

Runs from the root of a checkout that holds ``BENCHMARK.json``.  Earlier
lines, on standard error, give the card's name and power limit, the peak
of device memory, the kernels' build, the launch counts and, last, each
number of the comparison beside its limit; the last line of standard
output is the result: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and ``checks``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_object_detection_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as cell_lib
    from benchmark.harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = cell_lib.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
