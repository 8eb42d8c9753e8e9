"""PointPillars (Lang et al. 2019): voxelization, the network with its SSD
and center heads, decoding, the training loss and anchor assigner,
augmentation, the initializer, the trainer, and the Flax weight mapping
in both directions."""

from lidar_object_detection_tpu_torch.models.pointpillars.voxelize import (
    PillarGridConfig, pillar_ids, point_features, scatter_bev)
from lidar_object_detection_tpu_torch.models.pointpillars.model import (
    PillarsConfig, PointPillars, PillarFeatureNet)
from lidar_object_detection_tpu_torch.models.pointpillars.decode import (
    anchor_grid, decode_boxes, encode_boxes, bev_aabb, decode_predictions,
    corners_to_boxes7, boxes7_to_corners)
from lidar_object_detection_tpu_torch.models.pointpillars.center import (
    CenterHead, decode_center, center_loss)
from lidar_object_detection_tpu_torch.models.pointpillars.loss import (
    assign_anchors, pointpillars_loss)
from lidar_object_detection_tpu_torch.models.pointpillars.weights import (
    pillars_flax_from_state, pillars_state_from_flax)
from lidar_object_detection_tpu_torch.models.pointpillars.train import (
    PillarsTrainer, TrainState, adamw_update)

__all__ = [
    "PillarGridConfig", "pillar_ids", "point_features", "scatter_bev",
    "PillarsConfig", "PointPillars", "PillarFeatureNet",
    "anchor_grid", "decode_boxes", "encode_boxes", "bev_aabb",
    "decode_predictions", "corners_to_boxes7", "boxes7_to_corners",
    "CenterHead", "decode_center", "center_loss",
    "assign_anchors", "pointpillars_loss",
    "pillars_flax_from_state", "pillars_state_from_flax",
    "PillarsTrainer", "TrainState", "adamw_update",
]
