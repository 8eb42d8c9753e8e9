"""Write the JPEG fixtures of ``chip_smoke.py``'s JPEG phase with Pillow.

    python tests/fixtures/jpeg/make_fixtures.py

The card's machine has no Pillow, so the files Pillow writes, and the
SHA-256 of the pixels Pillow decodes from them, are committed here; the
phase holds the port's codec to them.  Each fixture is cut from the
committed frame ``artifacts/learned_detector/seg_overlays/0000000100.png``
and saved by Pillow with the options in ``FIXTURES``.  ``fixtures.json``
also records the SHA-256 of Pillow's ``save`` bytes, at its defaults, of
the crop ``ENCODE_CROP`` of the same frame.
"""

import hashlib
import json
import os
import sys

import numpy as np
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
FRAME = os.path.join("artifacts", "learned_detector", "seg_overlays",
                     "0000000100.png")
# name -> (crop y0, y1, x0, x1, mode, Pillow save options)
FIXTURES = {
    "baseline_420_375x1242.jpg": ((0, 375, 0, 1242), "RGB", {}),
    "progressive_420_160x480.jpg": ((120, 280, 400, 880), "RGB",
                                    {"progressive": True}),
    "restart_444_120x360.jpg": ((200, 320, 900, 1260), "RGB",
                                {"subsampling": "4:4:4",
                                 "restart_marker_blocks": 5}),
    "grey_200x600.jpg": ((100, 300, 700, 1300), "L", {}),
}
ENCODE_CROP = (64, 184, 256, 616)


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def main() -> int:
    frame = Image.open(os.path.join(REPO, FRAME)).convert("RGB")
    pixels = np.asarray(frame)
    record = {"frame": FRAME, "pillow": Image.__version__,
              "libjpeg_turbo": features.version_feature("libjpeg_turbo"),
              "fixtures": {}}
    for name, ((y0, y1, x0, x1), mode, options) in FIXTURES.items():
        crop = Image.fromarray(np.ascontiguousarray(pixels[y0:y1, x0:x1]))
        path = os.path.join(HERE, name)
        crop.convert(mode).save(path, **options)
        decoded = np.asarray(Image.open(path).convert("RGB"))
        record["fixtures"][name] = {
            "crop": [y0, y1, x0, x1], "mode": mode, "options": options,
            "shape": list(decoded.shape), "bytes": os.path.getsize(path),
            "pixels_sha256": sha256(decoded.tobytes())}
    y0, y1, x0, x1 = ENCODE_CROP
    path = os.path.join(HERE, "encode_crop.jpg")
    Image.fromarray(np.ascontiguousarray(pixels[y0:y1, x0:x1])).save(path)
    with open(path, "rb") as f:
        record["encode"] = {"crop": list(ENCODE_CROP),
                            "sha256": sha256(f.read())}
    os.unlink(path)
    with open(os.path.join(HERE, "fixtures.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
