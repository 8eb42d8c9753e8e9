"""Host milliseconds of the port's JPEG codec, beside Pillow's where the
machine has Pillow.

    python tests/fixtures/jpeg/codec_times.py [--reps 20]

Times decoding ``baseline_420_375x1242.jpg`` (a 375 x 1242 4:2:0 file
Pillow wrote at its defaults) and encoding the same crop of the committed
frame at the defaults: the median of ``--reps`` calls after one warm-up,
for the native codec (``backend="native"``) and Pillow
(``np.asarray(Image.open(...).convert("RGB"))``, ``Image.fromarray(...)
.save(...)``), and one call of the numpy twin.  Prints one JSON line with
the card's name and power limit when ``nvidia-smi`` answers.
"""

import argparse
import io
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)

from chip_smoke import host_ms  # noqa: E402
from lidar_object_detection_tpu_torch.utils import jpeg  # noqa: E402
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb  # noqa


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    with open(os.path.join(HERE, "fixtures.json")) as f:
        record = json.load(f)
    with open(os.path.join(HERE, "baseline_420_375x1242.jpg"), "rb") as f:
        data = f.read()
    y0, y1, x0, x1 = record["fixtures"]["baseline_420_375x1242.jpg"]["crop"]
    image = np.ascontiguousarray(
        read_png_rgb(os.path.join(REPO, record["frame"]))[y0:y1, x0:x1])
    t = time.perf_counter()
    jpeg.build()
    out = {"build_s": time.perf_counter() - t, "reps": args.reps,
           "shape": list(image.shape),
           "native_decode_ms": host_ms(lambda: jpeg.read_jpeg_rgb(data),
                                         args.reps),
           "native_encode_ms": host_ms(lambda: jpeg.encode_jpeg_rgb(image),
                                         args.reps)}
    for name, fn in (("numpy_decode_ms",
                      lambda: jpeg.read_jpeg_rgb(data, backend="numpy")),
                     ("numpy_encode_ms",
                      lambda: jpeg.encode_jpeg_rgb(image, backend="numpy"))):
        t = time.perf_counter()
        fn()
        out[name] = (time.perf_counter() - t) * 1e3
    try:
        from PIL import Image, features
    except ImportError:
        out.update(pillow=None, pillow_decode_ms=None, pillow_encode_ms=None)
    else:
        def pil_encode():
            Image.fromarray(image).save(io.BytesIO(), format="JPEG")

        out.update(
            pillow=Image.__version__,
            libjpeg_turbo=features.version_feature("libjpeg_turbo"),
            pillow_decode_ms=host_ms(lambda: np.asarray(
                Image.open(io.BytesIO(data)).convert("RGB")), args.reps),
            pillow_encode_ms=host_ms(pil_encode, args.reps))
    out.update(host=platform.processor() or platform.machine(),
               cpus=os.cpu_count(), card=card())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
