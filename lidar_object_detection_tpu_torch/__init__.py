"""PyTorch and CUDA port of the KITTI-360 LiDAR-camera fusion framework.

The JAX package ``lidar_object_detection_tpu`` is the reference; this
package mirrors its layout so that each counterpart is easy to find, and
runs on an NVIDIA H100 (``sm_90a``).  It imports ``torch`` and never JAX,
Flax, ``msgpack``, PIL or pandas, and nothing of the JAX package.

Layer map (the slices ported so far):
  data/      KITTI-360 calibration and frame loading, padded batches
  geom/      projection and box geometry
  ops/       packed masks, erosion, NMS, and the hand-written CUDA kernels
             (``inside_counts``, ``mask_assembly``, ``nms``; sources in
             ``csrc/``)
  models/    the YOLO11-seg network, its weights, decode, TTA and detector;
             the stub detector
  fusion/    mask -> point association and the inside-count
  eval/      per-car statistics, the master CSV, the erosion study and its
             workbook
  pipelines/ the V1-V3 and csv_eval runner, and the CLI
             (``python -m lidar_object_detection_tpu_torch``)
  utils/     the flax msgpack checkpoint reader and the PNG decoder

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor each kernel wrapper takes its plain PyTorch twin; on a
CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, FusionParams, ShapeConfig)

__all__ = ["FusionConfig", "FusionParams", "ShapeConfig", "__version__"]
