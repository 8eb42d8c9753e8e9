"""KITTI (not 360) 2D-evaluation data: the ObjectDetection_YOLO
subproject's inputs (ObjectDetection_final.py:7-11,146-159).

Counterpart of ``lidar_object_detection_tpu/data/kitti2d.py``, kept as its
own copy.  Directory layout (KITTI_Selection): ``images/*.png``,
``labels/<name>.txt`` with lines ``class x1 y1 x2 y2 distance``,
``calib/<name>.txt`` holding the intrinsic matrix (``np.loadtxt``
parseable; only fx, fy, cx, cy are used).

:meth:`Kitti2DDataset.read_image` decodes ``.png`` and ``.jpg`` images
with the port's own codecs (``utils/image.py``: PNG or JPEG by the file's
signature), to the pixels the JAX package's PIL call gives.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from lidar_object_detection_tpu_torch.utils.image import read_image_rgb


@dataclasses.dataclass
class Kitti2DSample:
    name: str
    image_path: str
    gt_boxes: np.ndarray       # (M, 4) int xyxy
    gt_distances: np.ndarray   # (M,)
    intrinsics: Optional[np.ndarray]  # (3, 3) or None


class Kitti2DDataset:
    def __init__(self, root: str, images_dir: str = "images",
                 labels_dir: str = "labels", calib_dir: str = "calib"):
        self.root = root
        self.images_dir = os.path.join(root, images_dir)
        self.labels_dir = os.path.join(root, labels_dir)
        self.calib_dir = os.path.join(root, calib_dir)

    def sample_names(self) -> List[str]:
        return sorted(
            os.path.splitext(f)[0] for f in os.listdir(self.images_dir)
            if f.endswith((".png", ".jpg")))

    def load(self, name: str) -> Kitti2DSample:
        image_path = None
        for ext in (".png", ".jpg"):
            p = os.path.join(self.images_dir, name + ext)
            if os.path.isfile(p):
                image_path = p
                break
        if image_path is None:
            raise FileNotFoundError(f"no image for {name}")

        boxes, dists = [], []
        label_path = os.path.join(self.labels_dir, name + ".txt")
        if os.path.isfile(label_path):
            with open(label_path) as f:
                for line in f:
                    data = line.split()
                    if len(data) < 6:
                        continue
                    # reference: int(float(x)) truncation (:157)
                    boxes.append([int(float(v)) for v in data[1:5]])
                    dists.append(float(data[5]))
        calib_path = os.path.join(self.calib_dir, name + ".txt")
        intrinsics = None
        if os.path.isfile(calib_path):
            k = np.loadtxt(calib_path)
            intrinsics = k.reshape(3, -1)[:3, :3]
        return Kitti2DSample(
            name=name, image_path=image_path,
            gt_boxes=np.asarray(boxes, np.int64).reshape(-1, 4),
            gt_distances=np.asarray(dists, np.float64),
            intrinsics=intrinsics)

    @staticmethod
    def read_image(sample: Kitti2DSample) -> np.ndarray:
        """(H, W, 3) uint8 RGB of the sample's image, PNG or JPEG."""
        return read_image_rgb(sample.image_path)
