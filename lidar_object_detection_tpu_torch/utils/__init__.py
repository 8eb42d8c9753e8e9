from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack, unpackb)

__all__ = ["read_flax_msgpack", "unpackb"]
