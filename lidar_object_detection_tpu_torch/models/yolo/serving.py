"""Serving-checkpoint resolution.

Counterpart of ``lidar_object_detection_tpu/models/yolo/serving.py``.  A
committed detector checkpoint is a flax msgpack ``{"variables", "step"}``
(``convert-weights`` writes ``{"variables"}`` alone) plus a JSON sidecar
``<ckpt>.json`` with at least ``{"scale": ...}`` and, for tuned
checkpoints, a ``{"serving": {...}}`` block with the selected operating
point.  Precedence, per knob: explicit caller override > sidecar
``serving`` block > library default (``mask_threshold`` 0.5, the
detector's own ``conf``).

:func:`export_serving_checkpoint` writes such a checkpoint from a
distillation run (``examples/export_yolo_ckpt.py``; the CLI's
``yolo-export``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    packb, read_flax_msgpack)

__all__ = ["load_sidecar", "resolve_serving", "load_serving_checkpoint",
           "export_serving_checkpoint"]


def load_sidecar(ckpt_path: str) -> Dict[str, Any]:
    """The checkpoint's JSON sidecar, or {} when none exists."""
    path = ckpt_path + ".json"
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def resolve_serving(ckpt_path: str, *,
                    scale: Optional[str] = None,
                    conf: Optional[float] = None,
                    mask_threshold: Optional[float] = None,
                    mask_threshold_floor: Optional[float] = None,
                    mask_min_pixels: Optional[int] = None,
                    tta: Optional[str] = None,
                    default_scale: str = "n") -> Dict[str, Any]:
    """The serving config of a checkpoint: ``{"scale", "mask_threshold",
    "conf", "mask_threshold_floor", "mask_min_pixels", "tta"}``; ``conf``
    is None when neither the caller nor the sidecar pins one."""
    meta = load_sidecar(ckpt_path)
    serving = meta.get("serving", {})
    if scale is None:
        scale = meta.get("scale", default_scale)
    if mask_threshold is None:
        mask_threshold = float(serving.get("mask_threshold", 0.5))
    if conf is None and "conf" in serving:
        conf = float(serving["conf"])
    if mask_threshold_floor is None and "mask_threshold_floor" in serving:
        mask_threshold_floor = float(serving["mask_threshold_floor"])
    if mask_min_pixels is None:
        mask_min_pixels = int(serving.get("mask_min_pixels", 0))
    if tta is None:
        tta = str(serving.get("tta", "none"))
    if (mask_threshold_floor is not None
            and mask_threshold_floor >= float(mask_threshold)):
        # a threshold at or below the floor turns the guarded shrink off
        mask_threshold_floor, mask_min_pixels = None, 0
    return {"scale": scale, "mask_threshold": float(mask_threshold),
            "conf": conf, "mask_threshold_floor": mask_threshold_floor,
            "mask_min_pixels": mask_min_pixels, "tta": tta}


def load_serving_checkpoint(ckpt_path: str,
                            image_hw: Tuple[int, int] = (376, 1408),
                            *,
                            scale: Optional[str] = None,
                            conf: Optional[float] = None,
                            mask_threshold: Optional[float] = None,
                            mask_threshold_floor: Optional[float] = None,
                            mask_min_pixels: Optional[int] = None,
                            tta: Optional[str] = None,
                            max_detections: int = 32,
                            default_scale: str = "n",
                            **detector_kw):
    """A ``YoloDetector`` serving ``ckpt_path`` at its recorded operating
    point.  Returns ``(detector, step, resolved)``; extra keyword args go
    to ``YoloDetector`` (``device``, ``dtype``, ``fold_weights``, ...)."""
    from lidar_object_detection_tpu_torch.models.yolo.detector import (
        YoloDetector)
    from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig

    resolved = resolve_serving(ckpt_path, scale=scale, conf=conf,
                               mask_threshold=mask_threshold,
                               mask_threshold_floor=mask_threshold_floor,
                               mask_min_pixels=mask_min_pixels,
                               tta=tta, default_scale=default_scale)
    raw = read_flax_msgpack(ckpt_path)
    kw = dict(detector_kw)
    if resolved["conf"] is not None:
        kw["conf"] = resolved["conf"]
    det = YoloDetector(image_hw, YoloConfig(scale=resolved["scale"]),
                       variables=raw["variables"],
                       mask_threshold=resolved["mask_threshold"],
                       mask_threshold_floor=resolved["mask_threshold_floor"],
                       mask_min_pixels=resolved["mask_min_pixels"],
                       tta=resolved["tta"],
                       max_detections=max_detections, **kw)
    # convert-weights writes no step
    return det, int(np.asarray(raw.get("step", 0))), resolved


def _cast_tree(tree, dtype: str):
    """``tree`` with its float arrays stored as ``dtype`` (a numpy name or
    ``bfloat16``); bfloat16 arrays (torch tensors, as the reader gives
    them) and integer arrays stay as they are, as numpy's
    ``issubdtype(..., floating)`` leaves them in the JAX script."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and np.issubdtype(tree.dtype,
                                                      np.floating):
        if dtype == "bfloat16":
            return torch.from_numpy(tree).to(torch.bfloat16)
        return tree.astype(np.dtype(dtype))
    return tree


def export_serving_checkpoint(src: str, dst: str, dtype: str = "bfloat16",
                              serving: Optional[Dict[str, Any]] = None
                              ) -> Dict[str, Any]:
    """Write ``dst``, the slim serving checkpoint of the distillation run
    ``src``: ``{"variables", "step"}``, the EMA copy where ``src`` has one,
    float arrays stored as ``dtype``, in the bytes flax's
    ``msgpack_serialize`` writes; and ``dst.json``, ``src``'s sidecar with
    the ``serving`` block set where one is given (``mask_threshold``, and
    optionally ``mask_threshold_floor`` with ``mask_min_pixels``, and
    ``tta``).  Returns the payload's size in bytes, the step, the sidecar
    written ({} when none is) and the warnings of the JAX script."""
    raw = read_flax_msgpack(src)
    variables = raw.get("ema_variables") or raw["variables"]
    payload = packb({"variables": _cast_tree(variables, dtype),
                     "step": raw["step"]})
    tmp = dst + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, dst)

    meta = load_sidecar(src)
    warnings = []
    if serving is not None:
        meta["serving"] = {
            "mask_threshold": serving["mask_threshold"],
            "source": "examples/quality_knob_sweep.py (recorded at "
                      "export time)"}
        if serving.get("mask_threshold_floor") is not None:
            meta["serving"]["mask_threshold_floor"] = \
                serving["mask_threshold_floor"]
            meta["serving"]["mask_min_pixels"] = serving["mask_min_pixels"]
        if serving.get("tta") is not None:
            meta["serving"]["tta"] = serving["tta"]
    elif "serving" not in meta:
        warnings.append("WARNING: no serving block in the source sidecar "
                        "and no --serving-mask-thr given; the export will "
                        "serve at ultralytics' 0.5 default")
    if "scale" not in meta:
        warnings.append("WARNING: no 'scale' in the sidecar; consumers will "
                        "assume their default scale (models/yolo/"
                        "serving.py)")
    if meta:
        with open(dst + ".json", "w") as f:
            json.dump(meta, f)
    return {"bytes": len(payload), "step": int(np.asarray(raw["step"])),
            "sidecar": meta, "warnings": warnings}
