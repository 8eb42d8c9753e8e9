from lidar_object_detection_tpu_torch.fusion.associate import (
    fuse_batch,
    fuse_frame,
)

__all__ = ["fuse_batch", "fuse_frame"]
