"""Segmentation overlays of a directory of images.

Counterpart of ``lidar_object_detection_tpu/pipelines/overlay.py``
(``segment_overlay_dir``, Imagesegmentation_final.py:15-53): run the
detector over every image, blend its masks and draw its boxes, and write
the overlays.  Host-side drawing only; images are read by their signature
and written by their name's extension, PNG or JPEG, with ``utils/image.py``
(the JAX package uses PIL).
"""

from __future__ import annotations

import glob
import os

import torch

from lidar_object_detection_tpu_torch.ops.masks import unpack_masks
from lidar_object_detection_tpu_torch.utils.image import (read_image_rgb,
                                                          write_image_rgb)
from lidar_object_detection_tpu_torch.viz.overlay import (draw_boxes,
                                                          golden_colors,
                                                          overlay_masks)


def segment_overlay_dir(images_dir: str, output_dir: str, detector,
                        pattern: str = "*.png") -> int:
    """Detect and overlay every image of ``images_dir`` matching
    ``pattern``, writing overlays of the same names (and so formats) into
    ``output_dir``.
    Returns the image count.

    ``detector.detect`` takes (1, H, W, 3) uint8 and returns ``boxes``,
    ``det_valid`` and ``mask_bits`` (the ``YoloDetector`` interface),
    tensors or arrays on any device.
    """
    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for path in sorted(glob.glob(os.path.join(images_dir, pattern))):
        img = read_image_rgb(path)
        out = {k: torch.as_tensor(v).cpu()
               for k, v in detector.detect(img[None]).items()}
        det_valid = out["det_valid"][0].numpy().astype(bool)
        colors = golden_colors(max(int(det_valid.sum()), 1))
        masks = unpack_masks(out["mask_bits"][0].to(torch.int32),
                             len(det_valid)).numpy()[det_valid]
        boxes = out["boxes"][0].float().numpy()[det_valid]
        vis = draw_boxes(overlay_masks(img, masks, colors), boxes, colors)
        write_image_rgb(os.path.join(output_dir, os.path.basename(path)),
                        vis)
        count += 1
    return count
