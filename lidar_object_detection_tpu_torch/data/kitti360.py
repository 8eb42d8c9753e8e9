"""KITTI-360 loaders with fixed-shape padding.

Counterpart of ``lidar_object_detection_tpu/data/kitti360.py``, kept as its
own copy: Velodyne ``.bin`` scans, rectified PNGs and the 3D-box JSON of a
KITTI-360 directory tree, assembled into padded, masked, batch-ready numpy
arrays.  The reference reads these per frame with ragged shapes
(``Kitti360Viewer3DRaw.loadVelodyneData`` V1_BBox_Pointwise_filtering.py:
24-28, ``load_bounding_boxes`` V1:31-38, image path construction
V1:347-348); here every frame is padded to the static shapes of
:class:`~lidar_object_detection_tpu_torch.config.ShapeConfig` with validity
masks.

Images decode through :mod:`..utils.image` (PNG or JPEG by the file's
signature, with the port's own codecs), where the JAX package uses PIL.  The streaming path reads scans through the threaded
native prefetcher of :mod:`..data.native` and only the boxes through
:meth:`Kitti360Dataset.load_boxes`.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
from typing import List, Optional, Sequence

import numpy as np

from lidar_object_detection_tpu_torch.config import ShapeConfig
from lidar_object_detection_tpu_torch.data import calib as calib_lib
from lidar_object_detection_tpu_torch.utils.image import read_image_rgb


def sequence_name(seq: int) -> str:
    return "2013_05_28_drive_%04d_sync" % seq


def load_velodyne_scan(path: str) -> np.ndarray:
    """Read one raw Velodyne scan: float32 x4 (x, y, z, reflectance)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def load_bounding_boxes(json_path: str) -> List[dict]:
    """Load the per-frame GT 3D boxes: a JSON list of
    ``{"index": int, "corners_cam0": 8x[x,y,z]}`` (BBoxes_<frame>.json);
    [] when the file is missing."""
    try:
        with open(json_path, "r") as f:
            return json.load(f)
    except FileNotFoundError:
        return []


def _corners_of(boxes: List[dict]) -> np.ndarray:
    """(G, 8, 3) float64 cam0 corners of the boxes that carry them."""
    return np.asarray(
        [b["corners_cam0"] for b in boxes if "corners_cam0" in b],
        dtype=np.float64).reshape(-1, 8, 3)


@dataclasses.dataclass
class FrameRecord:
    """One frame's host-side data, still ragged."""

    frame_id: int
    points: np.ndarray          # (N, 4) float32
    corners_cam0: np.ndarray    # (G, 8, 3) float64
    image_path: Optional[str]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_boxes(self) -> int:
        return self.corners_cam0.shape[0]


@dataclasses.dataclass
class FrameBatch:
    """Fixed-shape batch: every array padded to the ``ShapeConfig`` sizes,
    with validity masks."""

    frame_ids: np.ndarray       # (B,) int32
    points: np.ndarray          # (B, P, 4) float32, padded with zeros
    point_valid: np.ndarray     # (B, P) bool
    corners_cam0: np.ndarray    # (B, G, 8, 3) float32
    box_valid: np.ndarray       # (B, G) bool
    image_paths: List[Optional[str]]

    @property
    def batch_size(self) -> int:
        return int(self.frame_ids.shape[0])


class Kitti360Dataset:
    """Loader over a KITTI-360 directory tree.

    Loading skips a frame whose scan is unreadable, whose box JSON is
    missing or empty, or whose image is missing, as the reference's
    skip-and-continue loop does (V1:318-351).  Only the Velodyne sensor and
    the rectified perspective cameras 0/1 are supported, as in the JAX
    package.
    """

    def __init__(self, root: str, seq: int = 0, cam_id: int = 0,
                 shapes: ShapeConfig = ShapeConfig(),
                 image_cache_dir: Optional[str] = None):
        self.root = root
        self.seq = seq
        self.cam_id = cam_id
        self.shapes = shapes
        # decode-once raw image cache: later runs read (H, W, 3) uint8
        # blobs instead of inflating PNGs; the pixels are the same
        self.image_cache_dir = image_cache_dir
        seq_name = sequence_name(seq)
        self.velodyne_dir = os.path.join(
            root, "data_3d_raw", seq_name, "velodyne_points", "data")
        self.bbox_dir = os.path.join(root, "bboxes_3D_cam0")
        self.image_dir = os.path.join(
            root, "data_2d_raw", seq_name, f"image_{cam_id:02d}",
            "data_rect" if cam_id in (0, 1) else "data_rgb")
        self.camera = calib_lib.load_perspective_camera(root, cam_id)
        self.transforms = calib_lib.build_transform_chain(root, self.camera)

    def frame_ids(self) -> List[int]:
        files = sorted(glob.glob(os.path.join(self.velodyne_dir, "*.bin")))
        return [int(os.path.basename(f).split(".")[0]) for f in files]

    def scan_path(self, frame_id: int) -> str:
        return os.path.join(self.velodyne_dir, "%010d.bin" % frame_id)

    def image_path(self, frame_id: int) -> str:
        return os.path.join(self.image_dir, "%010d.png" % frame_id)

    def bbox_path(self, frame_id: int) -> str:
        return os.path.join(self.bbox_dir, f"BBoxes_{frame_id}.json")

    def load_bboxes_exists(self, frame_id: int) -> bool:
        return os.path.isfile(self.bbox_path(frame_id))

    def tight_shapes(self, multiple: int = 4096) -> ShapeConfig:
        """ShapeConfig with max_points padded to this dataset's largest
        scan, rounded up to ``multiple`` and capped at the configured
        max_points."""
        biggest = 0
        for fid in self.frame_ids():
            biggest = max(biggest,
                          os.path.getsize(self.scan_path(fid)) // 16)
        padded = ((biggest + multiple - 1) // multiple) * multiple
        return dataclasses.replace(self.shapes,
                                   max_points=min(padded,
                                                  self.shapes.max_points))

    def load_boxes(self, frame_id: int) -> Optional[np.ndarray]:
        """The frame's GT corners (G, 8, 3) float64 alone, or None when its
        box JSON is missing or empty: the streaming path's read, whose scans
        come from the prefetcher and are not read again."""
        boxes = load_bounding_boxes(self.bbox_path(frame_id))
        if not boxes:
            return None
        return _corners_of(boxes)

    def load_frame(self, frame_id: int, require_boxes: bool = True,
                   require_image: bool = True) -> Optional[FrameRecord]:
        """One frame, or None when a skip rule applies."""
        try:
            points = load_velodyne_scan(self.scan_path(frame_id))
        except (FileNotFoundError, ValueError):
            return None
        boxes = load_bounding_boxes(self.bbox_path(frame_id))
        if require_boxes and not boxes:
            return None
        corners = _corners_of(boxes)
        image_path = self.image_path(frame_id)
        if not os.path.isfile(image_path):
            if require_image:
                return None
            image_path = None
        return FrameRecord(frame_id=frame_id, points=points,
                           corners_cam0=corners, image_path=image_path)

    def load_frames(self, frame_ids: Optional[Sequence[int]] = None,
                    require_boxes: bool = True,
                    require_image: bool = True) -> List[FrameRecord]:
        if frame_ids is None:
            frame_ids = self.frame_ids()
        records = []
        for fid in frame_ids:
            rec = self.load_frame(fid, require_boxes=require_boxes,
                                  require_image=require_image)
            if rec is not None:
                records.append(rec)
        return records

    def make_batch(self, records: Sequence[FrameRecord]) -> FrameBatch:
        """Pad a list of ragged frames into one fixed-shape batch."""
        s = self.shapes
        batch = len(records)
        points = np.zeros((batch, s.max_points, 4), dtype=np.float32)
        point_valid = np.zeros((batch, s.max_points), dtype=bool)
        corners = np.zeros((batch, s.max_boxes, 8, 3), dtype=np.float32)
        box_valid = np.zeros((batch, s.max_boxes), dtype=bool)
        frame_ids = np.zeros((batch,), dtype=np.int32)
        image_paths: List[Optional[str]] = []
        for i, rec in enumerate(records):
            n = rec.num_points
            if n > s.max_points:
                raise ValueError(
                    f"frame {rec.frame_id}: {n} points exceed "
                    f"max_points={s.max_points}")
            g = rec.num_boxes
            if g > s.max_boxes:
                raise ValueError(
                    f"frame {rec.frame_id}: {g} boxes exceed "
                    f"max_boxes={s.max_boxes}")
            points[i, :n] = rec.points
            point_valid[i, :n] = True
            corners[i, :g] = rec.corners_cam0.astype(np.float32)
            box_valid[i, :g] = True
            frame_ids[i] = rec.frame_id
            image_paths.append(rec.image_path)
        return FrameBatch(frame_ids=frame_ids, points=points,
                          point_valid=point_valid, corners_cam0=corners,
                          box_valid=box_valid, image_paths=image_paths)

    def load_images(self, batch: FrameBatch) -> np.ndarray:
        """Decode the batch's RGB images to (B, H, W, 3) uint8, each placed
        at the top left of the configured image size."""
        s = self.shapes
        out = np.zeros((batch.batch_size, s.image_height, s.image_width, 3),
                       dtype=np.uint8)
        for i, path in enumerate(batch.image_paths):
            if path is None:
                continue
            img = self._decode_image(path)
            h = min(img.shape[0], s.image_height)
            w = min(img.shape[1], s.image_width)
            out[i, :h, :w] = img[:h, :w]
        return out

    def _decode_image(self, path: str) -> np.ndarray:
        """One image as (h, w, 3) uint8, through the raw cache when set."""
        s = self.shapes
        if not self.image_cache_dir:
            return read_image_rgb(path)
        # basenames repeat across sequences and cameras, and the blob is
        # shaped by ShapeConfig: the key holds the full path and the shape
        digest = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
        raw = os.path.join(
            self.image_cache_dir,
            f"{digest}_{s.image_height}x{s.image_width}_"
            f"{os.path.basename(path)}.raw")
        if os.path.exists(raw):
            return np.fromfile(raw, np.uint8).reshape(
                s.image_height, s.image_width, 3)
        img = read_image_rgb(path)
        os.makedirs(self.image_cache_dir, exist_ok=True)
        full = np.zeros((s.image_height, s.image_width, 3), np.uint8)
        h = min(img.shape[0], s.image_height)
        w = min(img.shape[1], s.image_width)
        full[:h, :w] = img[:h, :w]
        full.tofile(raw)
        return full
