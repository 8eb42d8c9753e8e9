from lidar_object_detection_tpu_torch.utils.debug import (
    assert_finite, coordinate_ranges, nan_guard)
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack, unpackb)
from lidar_object_detection_tpu_torch.utils.image import (
    read_image_rgb, write_image_rgb)
from lidar_object_detection_tpu_torch.utils.jpeg import (
    read_jpeg_rgb, write_jpeg_rgb)
from lidar_object_detection_tpu_torch.utils.png import (
    read_png_rgb, write_png_rgb)
from lidar_object_detection_tpu_torch.utils.profiling import (
    StageTimer, device_barrier, device_name, time_calls, trace)

__all__ = ["StageTimer", "assert_finite", "coordinate_ranges",
           "device_barrier", "device_name", "nan_guard",
           "read_flax_msgpack", "read_image_rgb", "read_jpeg_rgb",
           "read_png_rgb", "time_calls", "trace", "unpackb",
           "write_image_rgb", "write_jpeg_rgb", "write_png_rgb"]
