from lidar_object_detection_tpu_torch.eval.statistics import (
    CarStatistics,
    frame_statistics,
    summarize,
)

__all__ = ["CarStatistics", "frame_statistics", "summarize"]
