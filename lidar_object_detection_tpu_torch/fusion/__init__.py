from lidar_object_detection_tpu_torch.fusion.associate import (
    fuse_batch,
    fuse_frame,
    greedy_iou_match,
    hungarian_cost,
    hungarian_match,
    matching_scores,
    point_inside_labels,
)

__all__ = ["fuse_batch", "fuse_frame", "greedy_iou_match", "hungarian_cost",
           "hungarian_match", "matching_scores", "point_inside_labels"]
