"""Rates of the copies from the host to the card, by the ring's size.

    python -m lidar_object_detection_tpu_torch.tools.h2d_times \
        [--slot-mb 2,4,8,16] [--slots 2,4,6] [--repeat 5]

Sources of the benchmark's sizes, made once from a seed in pageable host
memory: a chunk of 64 frames of 376 x 1408 x 3 uint8 (101.6 MB) and 64
scans of 131,072 x 4 float32 (134.2 MB).  For each, the host clock from
the call to a ``torch.cuda.synchronize()`` after it, the median of
``--repeat`` calls after a warm-up: a plain ``.to("cuda")``, the copy
from a pinned tensor, and ``utils.h2d.Uploader(...).submit([src])
.result()`` for every slot size and count asked for.  It prints the
card's name and power limit, then one JSON line a case (``case``,
``slot_mb``, ``slots``, ``ms``, ``gbps``).  On the card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from lidar_object_detection_tpu_torch.utils import h2d, profiling


def _ms(fn, repeat: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slot-mb", default="2,4,8,16")
    ap.add_argument("--slots", default="2,4,6")
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the copies to the card are timed on the card")
    dev = torch.device("cuda")
    print(profiling.device_name(dev), flush=True)
    rng = np.random.default_rng(0)
    sources = {
        "frames_u8": rng.integers(0, 256, (64, 376, 1408, 3), np.uint8),
        "scans_f32": rng.standard_normal((64, 131072, 4), np.float32)}

    def line(case, name, src, ms, slot_mb=None, slots=None):
        print(json.dumps({"case": case, "source": name, "slot_mb": slot_mb,
                          "slots": slots, "ms": round(ms, 3),
                          "gbps": round(src.nbytes / ms / 1e6, 2)}),
              flush=True)

    for name, src in sources.items():
        t = torch.from_numpy(src)
        line("pageable .to", name, src, _ms(lambda: t.to(dev), args.repeat))
        pinned = t.pin_memory()
        line("pinned .to", name, src, _ms(
            lambda: pinned.to(dev, non_blocking=True), args.repeat))
        del pinned
        for mb in (float(x) for x in args.slot_mb.split(",")):
            for slots in (int(x) for x in args.slots.split(",")):
                up = h2d.Uploader(dev, slot_bytes=int(mb * (1 << 20)),
                                  slots=slots)
                try:
                    ms = _ms(lambda: up.submit([src]).result(), args.repeat)
                finally:
                    up.close()
                line("ring", name, src, ms, mb, slots)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
