"""The ported pipelines: the runner's version entry points and the CLI
(``python -m lidar_object_detection_tpu_torch``)."""

from lidar_object_detection_tpu_torch.pipelines.runner import (
    FrameResult,
    FusionPipeline,
    RunResult,
    csv_eval,
    v1_pointwise,
    v2_stats,
    v3_erosion,
    v4_iou,
    v5_projected,
)

__all__ = [
    "FrameResult", "FusionPipeline", "RunResult",
    "csv_eval", "v1_pointwise", "v2_stats", "v3_erosion", "v4_iou",
    "v5_projected",
]
