"""Training and scale-out: the optimizer's arithmetic (:mod:`.optim`), the
YOLO11-seg trainer (:mod:`.train`), and the (data, model) mesh over
``torch.distributed`` (:mod:`.distributed`, :mod:`.mesh`,
:mod:`.collectives`, :mod:`.sharding`, :mod:`.pipeline`, :mod:`.dryrun`).

Exports what the JAX package's ``parallel/__init__.py`` exports, but
``CheckpointManager``: orbax imports JAX.
"""

from lidar_object_detection_tpu_torch.parallel import distributed
from lidar_object_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, data_sharding, make_mesh, point_sharding,
    replicated)
from lidar_object_detection_tpu_torch.parallel.pipeline import (
    pipeline_apply, pipeline_loss_fn)
from lidar_object_detection_tpu_torch.parallel.sharding import (
    point_sharded_fuse_frame, sharded_fuse_batch)
from lidar_object_detection_tpu_torch.parallel.train import (
    TrainState, YoloTrainer, detection_loss, param_shardings)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "make_mesh", "data_sharding", "replicated",
    "point_sharding", "sharded_fuse_batch", "point_sharded_fuse_frame",
    "YoloTrainer", "TrainState", "detection_loss", "param_shardings",
    "pipeline_apply", "pipeline_loss_fn", "distributed",
]
