"""The YOLO cells' per-layer readings through their family: on a fixed
fake record, trace summary and spans, ``read_per_layer`` gives for every
metric of both cells the value that the harness gave before families
existed (written here as it read them), and ``mfu.serve`` through the
family's ``model_flops_per_frame`` equals that harness's formula: the
operations of a 192 x 640 view (``test_bench_reference.py``) x views x
frames over the window outside the profiled chunks and the dtype's
peak."""

import types

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cell_lib
from benchmark.harness import spec
from benchmark.harness.system import Spans

COMMON = {
    "forward_ms.serve": 81.58333333333333, "decode_ms.serve": 2.125,
    "fusion_ms.serve": 4.0625, "rows_ms.serve": 1.375,
    "inside_counts_roofline": 0.5187066392177047,
    "mask_assemble_roofline": 3.5333930348258704,
    "idle_share": 32.800000000000004, "launches_per_frame": 49.515625}
BEFORE = {
    "x_headline_b64": dict(COMMON, **{"mfu.serve": 5.615940183588073}),
    "n_csv_tta_b64": dict(COMMON, **{"mfu.serve": 5.448223205037454}),
}
# a view's operations, views, the peak of the configuration's dtype
MFU = {"x_headline_b64": (88_908_687_360, 1, 989e12),
       "n_csv_tta_b64": (2_921_629_440, 2, 67e12)}


def fake_inputs():
    rng = np.random.default_rng(25)
    b, d, p, g = 2, 32, 4096, 384
    x0 = rng.uniform(0, 1200, (b, d))
    y0 = rng.uniform(0, 300, (b, d))
    boxes = np.stack([
        x0, y0, np.minimum(x0 + rng.uniform(20, 200, (b, d)), 1408),
        np.minimum(y0 + rng.uniform(10, 80, (b, d)), 376)], -1)
    det = {"boxes": torch.from_numpy(boxes.astype(np.float32)),
           "det_valid": torch.from_numpy(rng.uniform(size=(b, d)) < 0.4)}
    words = rng.integers(1, 2 ** 20, (b, p)) * (rng.uniform(size=(b, p))
                                                < 0.3)
    fused = {"point_bits": torch.from_numpy(words.astype(np.int32)),
             "box_visible": torch.from_numpy(rng.uniform(size=(b, g))
                                             < 0.7)}
    record = types.SimpleNamespace(frames=6400, window_s=10.25,
                                   operands=[(det, fused)] * 3)
    summary = {"busy_s": 0.21, "window_s": 0.3125, "frames": 192,
               "kernels": 9507, "device_time_by_name": {
                   "void inside_counts_kernel<32>(int const*)": 8.7e-5,
                   "void mask_kernel<0, 32>(float const*)": 1.08e-4,
                   "void mask_kernel<1, 32>(float const*)": 5e-5,
                   "sm90_xmma_fprop_implicit_gemm_bf16": 0.2}}
    spans = Spans("cpu")
    spans.host_ms = {"forward": [81.5, 83.25, 80.0], "decode": [2.0, 2.25],
                     "fusion": [4.125, 4.0], "rows": [1.5, 1.375, 1.25]}
    return record, spans, summary


@pytest.mark.parametrize("workload", sorted(BEFORE))
def test_readings_did_not_move(workload):
    out = cell_lib.read_per_layer(spec.load_cell(workload), *fake_inputs())
    assert {k: v["value"] for k, v in out.items()} == BEFORE[workload]


@pytest.mark.parametrize("workload", sorted(MFU))
def test_mfu_is_the_old_formula(workload):
    per_view, views, peak = MFU[workload]
    cell = spec.load_cell(workload)
    record = fake_inputs()[0]
    assert cell.family.layer_context(cell, record)[
        "model_flops_per_frame"] == per_view * views
    old = per_view * views * (6400 - 192) / (10.25 - 0.3125) / peak * 100.0
    out = cell_lib.read_per_layer(cell, *fake_inputs())
    assert out["mfu.serve"]["value"] == old == BEFORE[workload]["mfu.serve"]
