from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack, unpackb)
from lidar_object_detection_tpu_torch.utils.png import (
    read_png_rgb, write_png_rgb)

__all__ = ["read_flax_msgpack", "read_png_rgb", "unpackb", "write_png_rgb"]
