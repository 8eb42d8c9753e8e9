"""The comparison's readings over many seeds in one process, for setting
its limits: the program's (sound runs), with ``--control`` the control's
(``harness/control.py``), or with ``--fault`` the program's with a fault
planted underneath (``harness/faults.py``).  Each seed makes its chunk,
runs a short window of it and is judged as a run is; one JSON line a
seed.

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
from benchmark.harness import judge as judge_lib  # noqa: E402
from benchmark.harness import spec, traffic  # noqa: E402
from benchmark.harness.control import ControlSystem  # noqa: E402
from benchmark.harness.faults import FAULTS  # noqa: E402
from benchmark.harness.system import PortSystem  # noqa: E402
from benchmark.reference.system import Reference  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    if args.fault:
        FAULTS[args.fault](setattr)
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda")
    no_limits = {k: float("inf") for k in judge_lib.NUMBERS}
    with tempfile.TemporaryDirectory(prefix="bench-calib-") as workdir:
        if args.control:
            system = ControlSystem(spec.ROOT, cell, dev)
        else:
            system = PortSystem(spec.ROOT, cell.config, cell.mix, dev,
                                workdir)
        reference = Reference(spec.ROOT, cell.config, dev)
        for seed in args.seeds:
            t0 = time.perf_counter()
            chunk = traffic.make_chunk(spec.ROOT, cell.mix, cell.config,
                                       seed)
            system.step(chunk)
            record = cell_lib.run_window(system, chunk, args.seconds, seed,
                                         int(cell.mix["judge_chunks"]))
            samples = [{"index": s["index"],
                        "det": judge_lib.host_detections(s["det"]),
                        "fused": s["fused"], "rows": s["rows"]}
                       for s in record.samples]
            # the control launches no kernel of the program
            launch_bad = 0 if args.control else record.launch_bad
            numbers, _ = judge_lib.judge(reference, chunk, samples,
                                         launch_bad, no_limits,
                                         cell.config["serving"]["conf"])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": args.control, "fault": args.fault,
                              "chunks": record.chunks,
                              "seconds": time.perf_counter() - t0,
                              **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
