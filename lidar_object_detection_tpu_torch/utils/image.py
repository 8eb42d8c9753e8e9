"""Image reading and writing by format, as the JAX package's Pillow calls.

``Image.open(path)`` picks the decoder from the file's first bytes, not
its name, and ``Image.fromarray(x).save(path)`` picks the encoder from
the name's extension.  :func:`read_image_rgb` and :func:`write_image_rgb`
do the same with the port's own codecs: PNG (``utils/png.py``) and JPEG
(``utils/jpeg.py``).  Any other format raises ``ValueError``.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np

from lidar_object_detection_tpu_torch.utils import jpeg, png

PathLike = Union[str, os.PathLike]


def read_image_rgb(path: PathLike) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG or JPEG file, by its signature: the
    pixels of ``np.asarray(Image.open(path).convert("RGB"))``."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == png.SIGNATURE:
        return png.read_png_rgb(os.fspath(path))
    if head[:3] == jpeg.SIGNATURE:
        return jpeg.read_jpeg_rgb(path)
    raise ValueError(f"{os.fspath(path)}: neither PNG nor JPEG (signature "
                     f"{head.hex()})")


def write_image_rgb(path: PathLike, image: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB in the format of the name's extension, as
    Pillow's ``save`` at its defaults: ``.png`` as PNG, ``.jpg`` and
    ``.jpeg`` (any case) as JPEG."""
    ext = os.path.splitext(os.fspath(path))[1].lower()
    if ext == ".png":
        png.write_png_rgb(os.fspath(path), image)
    elif ext in (".jpg", ".jpeg"):
        jpeg.write_jpeg_rgb(path, image)
    else:
        raise ValueError(f"{os.fspath(path)}: no image format for the "
                         f"extension {ext!r} (.png, .jpg or .jpeg)")
