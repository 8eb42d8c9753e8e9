"""The rotated-NMS kernel (``csrc/rotated_nms.cu``) and the PointPillars
decode on a card, against their plain twins.  Every test here is marked
``cuda`` and skips where ``torch.cuda.is_available()`` is False.

This file imports nothing of JAX, Flax or the JAX package, so that it
collects on the card's machine:

    python -m pytest tests/test_torch_cuda_pointpillars.py -m cuda

Tolerances: the kernel's IoU rows within 1e-5 of the twin's matrix rows
(the shoelace area is summed in another order); picks and keep flags
exact, on inputs whose deciding IoUs all lie further than 1e-5 from the
threshold (checked); decodes on the card against the CPU decode of the
same heads: validity and classes exact, boxes7 within 1e-4, scores within
1e-6.
"""

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_rotated_nms_kernel_equals_twin(dev):
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.ops import rotated_nms as rn
    from lidar_object_detection_tpu_torch.ops.rotated_iou import (
        rotated_iou_matrix)

    rng = np.random.default_rng(0)
    thr, m = chip_smoke.PP_IOU_THRESHOLD, chip_smoke.PP_MAX_DETECTIONS
    for name, case in chip_smoke.rotated_nms_cases(rng).items():
        bx, sc, va = (torch.from_numpy(a).to(dev) for a in case)
        before = kernel_lib.LAUNCHES["rotated_nms"]
        idx, keep, rows = rn.rotated_nms_cuda(bx, sc, va, thr, m,
                                              iou_rows=True)
        assert kernel_lib.LAUNCHES["rotated_nms"] == before + 1
        ref_idx, ref_keep = rn.rotated_nms_plain(bx, sc, va, thr, m)
        torch.cuda.synchronize()
        gaps, close = chip_smoke.replay_rotated_nms(
            rows.cpu().numpy(), idx.cpu().numpy(), keep.cpu().numpy(),
            case[1], case[2], thr)
        assert min(gaps) > chip_smoke.PP_IOU_TOL, name
        assert torch.equal(idx, ref_idx), name
        assert torch.equal(keep, ref_keep), name
        for f in range(bx.shape[0]):
            k = int(keep[f].sum())
            if k:
                iou = rotated_iou_matrix(bx[f], bx[f])
                err = (rows[f, :k] - iou[idx[f, :k].long()]).abs().max()
                assert float(err) <= chip_smoke.PP_IOU_TOL, name
        if name == "all invalid":
            assert not keep.any()
        else:
            assert int(keep.sum()) >= 4, name


def test_rotated_nms_dispatch_and_refusals(dev):
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.ops import rotated_nms as rn

    rng = np.random.default_rng(1)
    bx, sc, va = chip_smoke.rotated_nms_cases(rng, batch=1, n=200)[
        "heavy overlap"]
    bx, sc, va = (torch.from_numpy(a[0]).to(dev) for a in (bx, sc, va))
    before = kernel_lib.LAUNCHES["rotated_nms"]
    idx, keep = rn.rotated_nms(bx, sc, va, 0.5, 16)
    assert kernel_lib.LAUNCHES["rotated_nms"] == before + 1
    ref = rn.rotated_nms_plain(bx, sc, va, 0.5, 16)
    assert torch.equal(idx, ref[0]) and torch.equal(keep, ref[1])
    big = torch.zeros((1, 1025, 7), device=dev)
    with pytest.raises(ValueError, match="1024"):
        rn.rotated_nms_cuda(big, big[..., 0], big[..., 0] > 0, 0.5, 4)
    with pytest.raises(TypeError):
        rn.rotated_nms_cuda(bx[None].double(), sc[None], va[None], 0.5, 4)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rotated_nms_cuda(bx[None].cpu(), sc[None].cpu(), va[None].cpu(),
                            0.5, 4)


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_pointpillars_decode_on_card_equals_cpu(dev, head):
    """The committed checkpoint's heads on the card at a +-25.6 m grid,
    decoded on the card and on the CPU: the rotated NMS once per SSD
    frame, K5 once with the AABB decode."""
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarGridConfig, PillarsConfig, PointPillars, decode_predictions,
        pillars_state_from_flax)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    cfg = PillarsConfig(grid=PillarGridConfig(
        x_range=(-25.6, 25.6), y_range=(-25.6, 25.6), z_range=(-5.0, 1.5),
        pillar_size=0.32), head=head)
    model = PointPillars(cfg)
    model.load_state_dict(pillars_state_from_flax(read_flax_msgpack(
        chip_smoke.PP_CKPTS[head])["0"]), strict=True)
    model = model.to(dev).eval()
    pts, _ = chip_smoke.pillars_world(np.random.default_rng(3), 32768)
    points = torch.from_numpy(pts)[None].to(dev)
    with torch.inference_mode():
        raw = model(points, torch.ones(points.shape[:2], dtype=torch.bool,
                                       device=dev))
    one = {k: v[0] for k, v in raw.items()}
    modes = (True, False) if head == "ssd" else (True,)
    for rotated in modes:
        before = dict(kernel_lib.LAUNCHES)
        got = decode_predictions(one, cfg, score_threshold=0.05,
                                 rotated_nms=rotated)
        launched = {k: kernel_lib.LAUNCHES[k] - before[k] for k in before}
        want = {k: 0 for k in before}
        if head == "ssd":
            want["rotated_nms" if rotated else "nms"] = 1
        assert launched == want
        ref = decode_predictions({k: v.cpu() for k, v in one.items()}, cfg,
                                 score_threshold=0.05, rotated_nms=rotated)
        chip_smoke.same_detections(got, ref, f"{head} {rotated}", 1e-4,
                                   1e-6)
        assert int(got["valid"].sum()) >= 1
