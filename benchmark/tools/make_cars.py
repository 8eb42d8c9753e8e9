"""Write ``benchmark/data/cars/<config>.json``: the car boxes that a
configuration's reference finds in each committed camera frame of a
traffic mix, in float32 on the CPU.  The traffic
generator places the scenes' GT boxes behind them.

    python benchmark/tools/make_cars.py --config yolo11x-seg \
        --traffic headline_b64
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import spec  # noqa: E402
from benchmark.harness.png import read_png_rgb  # noqa: E402
from benchmark.harness.traffic import cars_path  # noqa: E402
from benchmark.reference.system import Reference  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    args = ap.parse_args(argv)
    config = spec.load_json("configs", args.config)
    mix = spec.load_json("traffic", args.traffic)
    sources = mix["frames"]["sources"]
    frames = [read_png_rgb(os.path.join(ROOT, s)) for s in sources]
    ref = Reference(ROOT, config, "cpu")
    boxes = []
    for image in frames:
        det = ref.detect(torch.from_numpy(np.ascontiguousarray(image[None])))
        boxes.append([[round(float(x), 2) for x in box]
                      for box in det["boxes"][0][det["det_valid"][0]]])
    out = cars_path(ROOT, args.config)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"config": args.config, "frames": sources,
                   "made_by": "benchmark/tools/make_cars.py (reference, "
                              "float32, CPU)",
                   "boxes": boxes}, f, indent=1)
    print(out, [len(b) for b in boxes])
    return 0


if __name__ == "__main__":
    sys.exit(main())
