"""The comparison's readings over many seeds in one process, for setting
its limits: the program's (sound runs), with ``--control`` the control's
(the family's ``control_system``), or with ``--fault`` the program's with
a fault of the family's ``FAULTS`` planted underneath.  Each seed makes
its chunk, runs a short window of it and is judged as a run is; one JSON
line a seed.

    python benchmark/tools/readings.py --workload n_csv_tta_b64 \
        --seconds 3 --seeds 11 12 13 [--control | --fault half_left_out]
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import cell as cell_lib  # noqa: E402
from benchmark.harness import spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", help="a key of the family's FAULTS")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    family = cell.family
    if args.fault:
        family.FAULTS[args.fault](setattr)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="bench-calib-") as workdir:
        make = family.control_system if args.control else family.make_system
        system = make(spec.ROOT, cell, dev, workdir, None)
        for seed in args.seeds:
            t0 = time.perf_counter()
            chunk = family.make_chunk(spec.ROOT, cell, seed, 0)
            system.step(chunk)
            record = cell_lib.run_window(system, family, chunk, args.seconds,
                                         seed, int(cell.mix["judge_chunks"]))
            samples = cell_lib.to_host(record.samples)
            # the control launches no kernel of the program
            launch_bad = 0 if args.control else record.launch_bad
            numbers, _ = family.judge(spec.ROOT, cell, dev, chunk, samples,
                                      launch_bad)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": args.control, "fault": args.fault,
                              "chunks": record.chunks,
                              "seconds": time.perf_counter() - t0,
                              **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
