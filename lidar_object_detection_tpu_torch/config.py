"""Configuration of the ported pipelines.

Counterpart of ``lidar_object_detection_tpu/config.py`` and of
``FusionParams`` in ``lidar_object_detection_tpu/fusion/associate.py``,
cut to the fields that the ported pipelines (V1-V3 and csv_eval: detector
-> fusion -> per-car statistics) read.  The reference defaults are the
same:

  depth < 50 m        V1_BBox_Pointwise_filtering.py:357
  depth < 30 m        V4_BBox_IoU_filtering.py:275, V5_ProjectingBBoxes.py:508
  min_points = 10     V1:401, cvs_erosion.py:372
  IoU gate 0.25       V4:140 (greedy matching)
  score >= 0.3, IoU >= 0.15   V5:308 (Hungarian matching)
  erosion kernel 3, 1 iter    V3_point_cloud_with_erosion.py:580,
                              cvs_erosion.py:77
  bbox visibility: >= 2 corners, depth > 0.1   V1:96-115
"""

from __future__ import annotations

import dataclasses
import enum


class PipelineVersion(enum.Enum):
    """The five reference fusion pipelines plus auxiliary entry points."""

    V1_POINTWISE = "v1_pointwise"      # V1_BBox_Pointwise_filtering.py
    V2_STATS = "v2_stats"              # V2_point_cloud_without_erosion.py
    V3_EROSION = "v3_erosion"          # V3_point_cloud_with_erosion.py
    V4_IOU = "v4_iou"                  # V4_BBox_IoU_filtering.py
    V5_PROJECTED = "v5_projected"      # V5_ProjectingBBoxes.py (Hungarian)
    CSV_EVAL = "csv_eval"              # cvs_erosion.py (headless metrics)
    DEPTH_MAPS = "depth_maps"          # seg_with_pointcloud.py
    KITTI2D_EVAL = "kitti2d_eval"      # ObjectDetection_final.py


class MatchStrategy(enum.Enum):
    POINT_COUNT = "point_count"   # best box by inside-point count (V1-V3, csv)
    GREEDY_IOU = "greedy_iou"     # greedy best-2D-IoU (V4)
    HUNGARIAN = "hungarian"       # weighted-score Hungarian assignment (V5)


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
    """The fusion knobs of every pipeline version with reference
    defaults; :meth:`for_version` pins each version's."""

    version: PipelineVersion = PipelineVersion.CSV_EVAL
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
    # off by default; for_version turns it on for V3_EROSION and CSV_EVAL
    erosion_enabled: bool = False
    erosion_kernel_size: int = 3
    erosion_iterations: int = 1
    match_strategy: MatchStrategy = MatchStrategy.POINT_COUNT
    min_points: int = 10
    greedy_min_iou: float = 0.25       # V4:140
    hungarian_min_score: float = 0.3   # V5:308
    hungarian_min_iou: float = 0.15    # V5:308
    score_weight_iou: float = 0.5      # V5:277
    score_weight_center: float = 0.3
    score_weight_size: float = 0.2
    center_norm: float = 1000.0        # V5:286 center-distance normalizer

    @staticmethod
    def for_version(version: PipelineVersion) -> "FusionConfig":
        """Reference-default config per pipeline version."""
        v = PipelineVersion
        if version in (v.V1_POINTWISE, v.V2_STATS, v.KITTI2D_EVAL):
            return FusionConfig(version=version)
        if version in (v.V3_EROSION, v.CSV_EVAL):
            return FusionConfig(version=version, erosion_enabled=True)
        if version == v.V4_IOU:
            # depth < 30 (V4:275) and greedy IoU >= 0.25
            return FusionConfig(version=version, depth_max=30.0,
                                match_strategy=MatchStrategy.GREEDY_IOU)
        if version == v.V5_PROJECTED:
            # V5 skips the visibility pre-filter entirely (V5:445-461)
            return FusionConfig(version=version, depth_max=30.0,
                                bbox_filter_enabled=False,
                                match_strategy=MatchStrategy.HUNGARIAN)
        if version == v.DEPTH_MAPS:
            # seg_with_pointcloud.py:154-158 uses depth < 30
            return FusionConfig(version=version, depth_max=30.0)
        raise ValueError(f"unknown version {version}")


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
