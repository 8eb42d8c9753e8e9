"""Configuration of the serving slice.

Counterpart of ``lidar_object_detection_tpu/config.py`` and of
``FusionParams`` in ``lidar_object_detection_tpu/fusion/associate.py``,
cut to the fields that the serving path (detector -> fusion -> per-car
statistics) reads.  The reference defaults are the same:

  depth < 50 m        V1_BBox_Pointwise_filtering.py:357
  min_points = 10     V1:401, cvs_erosion.py:372
  erosion kernel 3, 1 iter    cvs_erosion.py:77
  bbox visibility: >= 2 corners, depth > 0.1   V1:96-115
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """Static padded shapes of one frame."""

    max_points: int = 131072   # scans are 109,355-122,183 points
    max_detections: int = 32   # one bit each in the packed mask word
    max_boxes: int = 384       # BBoxes_2449.json has 314 boxes
    image_height: int = 376    # S_rect_00 in perspective.txt:8
    image_width: int = 1408


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """The fusion knobs of the csv_eval pipeline with reference defaults."""

    shapes: ShapeConfig = dataclasses.field(default_factory=ShapeConfig)
    depth_min: float = 0.0
    depth_max: float = 50.0
    bbox_filter_enabled: bool = True
    bbox_filter_mode: str = "simple"
    bbox_min_visible_corners: int = 2
    bbox_corner_depth_min: float = 0.1
    bbox_rich_depth_max: float = 100.0
    bbox_rich_min_corners_in_view: int = 4
    bbox_rich_min_area: float = 100.0
    # the csv_eval pipeline (cvs_erosion.py) serves with erosion on
    erosion_enabled: bool = False
    erosion_kernel_size: int = 3
    erosion_iterations: int = 1
    min_points: int = 10


@dataclasses.dataclass(frozen=True)
class FusionParams:
    """Static parameters of :func:`fusion.associate.fuse_frame`."""

    width: int
    height: int
    num_detections: int
    depth_min: float = 0.0
    depth_max: float = 50.0
    min_points: int = 10
    bbox_filter: bool = True
    # "simple" = filter_visible_bboxes (V1:96-115); "rich" = secondtest.py's
    # is_bbox_in_camera_view (depth range, intersection fallback, min area)
    bbox_filter_mode: str = "simple"
    bbox_min_visible_corners: int = 2
    bbox_corner_depth_min: float = 0.1
    bbox_rich_depth_max: float = 100.0
    bbox_rich_min_corners_in_view: int = 4
    bbox_rich_min_area: float = 100.0
    erosion_enabled: bool = False
    erosion_kernel_size: int = 3
    erosion_iterations: int = 1
    # points per step of the plain inside-count, which holds a
    # (chunk, G) inside matrix at a time
    count_chunk: int = 16384
    # "auto" = the hand-written kernel (ops/inside_counts.py) on a CUDA
    # tensor and its PyTorch twin on a CPU tensor; "plain" = the twin on
    # any device (the kernel's reference on the card)
    count_impl: str = "auto"

    @staticmethod
    def from_config(cfg: FusionConfig) -> "FusionParams":
        return FusionParams(
            width=cfg.shapes.image_width,
            height=cfg.shapes.image_height,
            num_detections=cfg.shapes.max_detections,
            depth_min=cfg.depth_min,
            depth_max=cfg.depth_max,
            min_points=cfg.min_points,
            bbox_filter=cfg.bbox_filter_enabled,
            bbox_filter_mode=cfg.bbox_filter_mode,
            bbox_min_visible_corners=cfg.bbox_min_visible_corners,
            bbox_corner_depth_min=cfg.bbox_corner_depth_min,
            bbox_rich_depth_max=cfg.bbox_rich_depth_max,
            bbox_rich_min_corners_in_view=cfg.bbox_rich_min_corners_in_view,
            bbox_rich_min_area=cfg.bbox_rich_min_area,
            erosion_enabled=cfg.erosion_enabled,
            erosion_kernel_size=cfg.erosion_kernel_size,
            erosion_iterations=cfg.erosion_iterations,
        )
