from lidar_object_detection_tpu_torch.utils.debug import (
    assert_finite, coordinate_ranges, nan_guard)
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack, unpackb)
from lidar_object_detection_tpu_torch.utils.png import (
    read_png_rgb, write_png_rgb)
from lidar_object_detection_tpu_torch.utils.profiling import (
    StageTimer, ThroughputMeter, device_barrier, device_name, time_calls,
    trace)

__all__ = ["StageTimer", "ThroughputMeter", "assert_finite",
           "coordinate_ranges", "device_barrier", "device_name", "nan_guard",
           "read_flax_msgpack", "read_png_rgb", "time_calls", "trace",
           "unpackb", "write_png_rgb"]
