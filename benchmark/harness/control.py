"""The control of the comparison: the reference put in the program's
place, its network computed one precision below the configuration's
(``control_precision``: TF32 for a float32 configuration with TF32 off,
fp8 for a bf16 one), decoding, fusing and writing rows as the reference
does.  It has to come out as not correct.  Only ``benchmark/tools``
and the tests run it; the benchmark's runs never do."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.harness.judge import CALIB
from benchmark.reference.system import Reference


class ControlSystem:
    """A system with the program's ``step`` interface: detections on the
    device, fused outputs on the host, the rows as tuples."""

    def __init__(self, root: str, cell, device, workdir: str = None,
                 spans=None):
        self.device = torch.device(device)
        self.reference = Reference(root, cell.config, self.device,
                                   precision=cell.config["control_precision"])

    def step(self, chunk):
        det = self.reference.detect(chunk.images)
        det_valid = det["det_valid"].cpu().numpy()
        fused_np = self.reference.fuse(chunk, det["mask_bits"].cpu().numpy(),
                                       det_valid, CALIB)
        rows = self.reference.rows(fused_np, det_valid)
        return det, fused_np, fused_np, det_valid, rows

    @staticmethod
    def launches() -> Dict[str, int]:
        return {}

    @staticmethod
    def build_info() -> dict:
        return {}
