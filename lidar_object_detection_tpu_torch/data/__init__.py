"""KITTI-360 calibration and frame loading (host-side numpy)."""

from lidar_object_detection_tpu_torch.data.calib import (
    CameraCalibration,
    TransformChain,
    build_transform_chain,
    load_calibration_camera_to_pose,
    load_calibration_rigid,
    load_perspective_camera,
)
from lidar_object_detection_tpu_torch.data.kitti360 import (
    FrameBatch,
    FrameRecord,
    Kitti360Dataset,
    load_bounding_boxes,
    load_velodyne_scan,
    sequence_name,
)

__all__ = [
    "CameraCalibration",
    "TransformChain",
    "build_transform_chain",
    "load_calibration_camera_to_pose",
    "load_calibration_rigid",
    "load_perspective_camera",
    "FrameBatch",
    "FrameRecord",
    "Kitti360Dataset",
    "load_bounding_boxes",
    "load_velodyne_scan",
    "sequence_name",
]
