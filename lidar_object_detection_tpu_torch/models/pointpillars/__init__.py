"""PointPillars (Lang et al. 2019) for inference: voxelization, the
network with its SSD and center heads, decoding, and the Flax weight
reader.  Training (the loss, the anchor assigner, augmentation, the
trainer) is ROADMAP Queue 1 item 7."""

from lidar_object_detection_tpu_torch.models.pointpillars.voxelize import (
    PillarGridConfig, pillar_ids, point_features, scatter_bev)
from lidar_object_detection_tpu_torch.models.pointpillars.model import (
    PillarsConfig, PointPillars, PillarFeatureNet)
from lidar_object_detection_tpu_torch.models.pointpillars.decode import (
    anchor_grid, decode_boxes, bev_aabb, decode_predictions,
    corners_to_boxes7, boxes7_to_corners)
from lidar_object_detection_tpu_torch.models.pointpillars.center import (
    CenterHead, decode_center)
from lidar_object_detection_tpu_torch.models.pointpillars.weights import (
    pillars_state_from_flax)

__all__ = [
    "PillarGridConfig", "pillar_ids", "point_features", "scatter_bev",
    "PillarsConfig", "PointPillars", "PillarFeatureNet",
    "anchor_grid", "decode_boxes", "bev_aabb",
    "decode_predictions", "corners_to_boxes7", "boxes7_to_corners",
    "CenterHead", "decode_center", "pillars_state_from_flax",
]
