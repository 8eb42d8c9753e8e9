from lidar_object_detection_tpu_torch.geom.projection import (
    cam2image,
    project_velo_points,
    point_validity,
)
from lidar_object_detection_tpu_torch.geom.boxes import (
    box_frame,
    corners_visibility,
    corners_visibility_rich,
    iou_2d_matrix,
    points_in_aabb,
    points_in_oriented_boxes,
    project_boxes_to_2d,
    transform_corners,
)

__all__ = [
    "cam2image",
    "project_velo_points",
    "point_validity",
    "box_frame",
    "corners_visibility",
    "corners_visibility_rich",
    "iou_2d_matrix",
    "points_in_aabb",
    "points_in_oriented_boxes",
    "project_boxes_to_2d",
    "transform_corners",
]
