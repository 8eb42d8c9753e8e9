"""The family ``yolo11-seg``: YOLO11-seg serving through the port's
``FusionPipeline`` (``harness/system.py``), fed one chunk of camera frames,
scans and cam0 boxes by the traffic generator (``harness/traffic.py``) and
judged against the plain reference (``harness/judge.py``,
``benchmark/reference/``).

Its per-layer context: the operands of K1 (``inside_counts``: the points'
membership words and the box mask) and of K2 (``mask_assemble``) of each
profiled chunk, and the network's operations a frame: 2 x the
multiply-adds of every convolution and linear layer of the published
network at the letterboxed input, counted by the reference's own layers
(``reference.yolo.conv_flops``), for each view the configuration runs.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from benchmark.harness import judge as judge_lib
from benchmark.harness import traffic
from benchmark.harness.control import ControlSystem
from benchmark.harness.faults import FAULTS  # noqa: F401
from benchmark.harness.system import (  # noqa: F401
    OFF_PATH_KERNELS, PATH_KERNELS, PortSystem)
from benchmark.reference import decode as ref_decode
from benchmark.reference.system import Reference
from benchmark.reference.yolo import Yolo11Seg, conv_flops

NUMBERS = judge_lib.NUMBERS
control_system = ControlSystem


def make_system(root: str, cell, device, workdir: str, spans=None):
    return PortSystem(root, cell.config, cell.mix, device, workdir, spans)


def make_chunk(root: str, cell, seed: int, chunk: int = 0):
    return traffic.make_chunk(root, cell.mix, cell.config, seed, chunk)


def sample(out) -> Dict:
    """The detections (on the device), the fused outputs on the host and
    the rows."""
    det, _, fused_np, _, rows = out
    return {"det": det, "fused": fused_np, "rows": rows}


def operands(system, chunk):
    """The chunk's detections and fused outputs, on the device."""
    return system.step(chunk)[:2]


def letterbox(config: dict):
    return ref_decode.LetterboxSpec.build(traffic.H0, traffic.W0,
                                          config["serving"]["imgsz"])


def mask_operands(config: dict, det: Dict[str, torch.Tensor]):
    """K2's operands of a chunk, as ``roofline.mask_bound`` takes them."""
    spec_ = letterbox(config)
    top, bottom, left, right = spec_.proto_crop(spec_.dst_h // 4,
                                                spec_.dst_w // 4)
    mh, mw = bottom - top, right - left
    taps = lambda n, m: np.argmax(ref_decode.resize_weight_matrix(n, m) > 0,
                                  axis=0)
    boxes = det["boxes"].float().cpu().numpy()
    return ((boxes.shape[0], config["serving"]["max_detections"], mh, mw),
            (traffic.H0, traffic.W0), taps(mh, traffic.H0),
            taps(mw, traffic.W0), boxes, det["det_valid"].cpu().numpy())


@functools.lru_cache(maxsize=None)
def flops_per_view(scale: str, input_hw) -> int:
    with torch.device("meta"):
        model = Yolo11Seg(scale)
    return conv_flops(model, input_hw)


def layer_context(cell, record) -> Dict:
    cfg = cell.config
    lb = letterbox(cfg)
    views = 2 if cfg["serving"]["tta"] == "hflip" else 1
    return {
        "model_flops_per_frame":
            flops_per_view(cfg["scale"], (lb.dst_h, lb.dst_w)) * views,
        # K1's operands (words, box mask) and K2's of each profiled chunk
        "k1_operands": [(f["point_bits"], f["box_visible"])
                        for _, f in record.operands],
        "mask_operands": [mask_operands(cfg, d) for d, _ in record.operands]}


def judge(root: str, cell, device, chunk, samples, launch_mismatch: int):
    reference = Reference(root, cell.config, device)
    return judge_lib.judge(reference, chunk, samples, launch_mismatch,
                           cell.config["limits"],
                           cell.config["serving"]["conf"])
