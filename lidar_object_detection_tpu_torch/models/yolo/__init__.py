from lidar_object_detection_tpu_torch.models.yolo.model import (
    Yolo11, YoloConfig)
from lidar_object_detection_tpu_torch.models.yolo.detector import (
    YoloDetector)
from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
    LetterboxSpec, PostprocessParams, postprocess_single)
from lidar_object_detection_tpu_torch.models.yolo.serving import (
    load_serving_checkpoint, resolve_serving)
from lidar_object_detection_tpu_torch.models.yolo.weights import (
    fold_serving_variables, from_flax_variables)

__all__ = ["Yolo11", "YoloConfig", "YoloDetector", "LetterboxSpec",
           "PostprocessParams", "postprocess_single",
           "load_serving_checkpoint", "resolve_serving",
           "fold_serving_variables", "from_flax_variables"]
