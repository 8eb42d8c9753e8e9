"""PyTorch and CUDA port of the KITTI-360 LiDAR-camera fusion framework.

The JAX package ``lidar_object_detection_tpu`` is the reference; this
package mirrors its layout so that each counterpart is easy to find, and
runs on an NVIDIA H100 (``sm_90a``).  It imports ``torch`` and never JAX,
Flax, ``msgpack`` or PIL, and nothing of the JAX package.

Layer map (the serving slice ported so far):
  geom/      projection and box geometry
  ops/       packed masks, erosion, NMS, and the hand-written CUDA kernels
             (``inside_counts``, ``mask_assembly``; sources in ``csrc/``)
  models/    the YOLO11-seg network, its weights, decode, TTA and detector
  fusion/    mask -> point association and the inside-count
  eval/      per-car statistics
  utils/     the flax msgpack checkpoint reader

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On a CPU tensor each kernel wrapper takes its plain PyTorch twin; on a
CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, FusionParams, ShapeConfig)

__all__ = ["FusionConfig", "FusionParams", "ShapeConfig", "__version__"]
