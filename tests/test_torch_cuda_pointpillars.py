"""The rotated-NMS kernel and the training assigner's IoU kernel
(``csrc/rotated_nms.cu``) and the PointPillars decode on a card, against
their plain twins; PointPillars inference repeating its bits on the card
(the pillar sums, the heads, and the ``pointpillars-infer`` CLI's JSON and
PLY files byte for byte); a training step on the card against the same
step on the CPU, and ``pointpillars-train`` writing the same checkpoint
bytes twice.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.

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

import os

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
        idx, keep, rows, slow = rn.rotated_nms_cuda(bx, sc, va, thr, m,
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
        # the ring routine: only degenerate boxes outgrow the slots
        if name == "degenerate":
            assert int(slow.sum()) > 0
        print(f"{name}: {int(slow.sum())} pairs through the ring routine")


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


def test_rotated_nms_signed_zero_scores_tie(dev):
    """Scores of -0.0 and +0.0 tie, as in jnp.argmax: apart boxes are
    picked in index order, whichever sign comes first."""
    from lidar_object_detection_tpu_torch.ops import rotated_nms as rn

    n = 40
    boxes = np.zeros((2, n, 7), np.float32)
    boxes[..., 0] = np.arange(n) * 10.0
    boxes[..., 3:6] = (1.8, 4.0, 1.5)
    scores = np.zeros((2, n), np.float32)
    scores[0, 0::2] = -0.0
    scores[1, 1::2] = -0.0
    bx, sc, va = (torch.from_numpy(a).to(dev) for a in (
        boxes, scores, np.ones((2, n), bool)))
    idx, keep = rn.rotated_nms_cuda(bx, sc, va, 0.5, n)
    ref_idx, ref_keep = rn.rotated_nms_plain(bx, sc, va, 0.5, n)
    torch.cuda.synchronize()
    assert torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    assert torch.equal(idx, torch.stack([order, order])) and bool(keep.all())


def test_pillar_sums_and_heads_repeat_on_card(dev):
    """The pillar sums (``index_add_`` in the deterministic scope) and the
    committed SSD checkpoint's heads at the surround grid give the same
    bits on every run on the card; the caller's determinism setting is
    left as it was."""
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, point_features)
    from lidar_object_detection_tpu_torch.pipelines import pointpillars as pp

    cfg = PillarsConfig.kitti360_surround()
    pts, _ = chip_smoke.pillars_world(np.random.default_rng(4), 131072)
    points, pv = pp.padded_cloud(pts, 131072, dev)
    setting = torch.are_deterministic_algorithms_enabled()
    feats = [point_features(points[0], pv[0], cfg.grid)[0]
             for _ in range(3)]
    assert torch.are_deterministic_algorithms_enabled() == setting
    assert all(torch.equal(f, feats[0]) for f in feats)
    model, _ = pp.load_pillars_model(chip_smoke.PP_CKPTS["ssd"], cfg, dev)
    with torch.inference_mode():
        heads = [model(points, pv) for _ in range(3)]
    for h in heads[1:]:
        assert all(torch.equal(h[k], heads[0][k]) for k in h)
    assert torch.are_deterministic_algorithms_enabled() == setting


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_pointpillars_cli_repeats_its_bytes(dev, tmp_path, head):
    """``pointpillars-infer`` run twice on the card over one tree (two
    frames of ``chip_smoke.pillars_tree``, sweeps aggregated) writes
    byte-equal JSON and PLY files."""
    root = str(tmp_path / "kitti360")
    chip_smoke.pillars_tree(root, np.random.default_rng(2))
    outs = []
    for run in range(2):
        out = str(tmp_path / f"run{run}")
        argv = ["pointpillars-infer", "--dataset", root, "--surround",
                "--aggregate-sweeps", "--export-ply", "--device", "cuda",
                "--ckpt", chip_smoke.PP_CKPTS[head], "--head", head,
                "--output", out, "--frames", "200", "201"]
        if head == "ssd":
            argv += ["--score-threshold", str(chip_smoke.PP_SSD_THRESHOLD)]
        chip_smoke.run_cli(argv)
        outs.append(out)
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1]))
    assert sum(n.endswith(".json") for n in names) == 2
    assert sum(n.endswith(".ply") for n in names) == 2
    for name in names:
        assert chip_smoke.read_bytes(os.path.join(outs[0], name)) == \
            chip_smoke.read_bytes(os.path.join(outs[1], name)), name


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


def _pair_edge_cases(rng, dev):
    """Operands of the assigner's IoU kernel for its work distribution:
    name -> (anchors, idx, gt, gt_valid).  K = 1500 random candidates a
    GT (past a block's 256 candidates: chunks on ``blockIdx.y``); every
    GT invalid; a frame whose GTs lie far from every anchor (no near
    pair) beside one among them; indices out of [0, n_anchors) (-1, n,
    n + 5) among valid and invalid GTs."""
    anchors = chip_smoke.car_boxes(torch, dev, rng, (4096,), 6.0)
    n = anchors.shape[0]
    gt = chip_smoke.car_boxes(torch, dev, rng, (2, 8), 6.0)
    ones = torch.ones((2, 8), dtype=torch.bool, device=dev)
    wide = torch.from_numpy(rng.integers(0, n, (2, 8, 1500))).to(dev)
    far = gt.clone()
    far[0, :, 0] += 500.0
    bad = torch.from_numpy(rng.integers(0, n, (2, 8, 300))).to(dev)
    bad[:, :, ::7] = -1
    bad[:, :, 1::7] = n
    bad[:, :, 2::11] = n + 5
    half = ones.clone()
    half[:, ::2] = False
    return {"K=1500": (anchors, wide, gt, ones),
            "every GT invalid": (anchors, wide, gt, ~ones),
            "no near pair in frame 0": (anchors, wide[:, :, :512].contiguous(),
                                        far, ones),
            "indices out of range": (anchors, bad, gt, half)}


def test_rotated_iou_pairs_kernel_equals_twin(dev):
    """The assigner's IoU kernel on ``chip_smoke.pair_cases`` (heavy
    overlap with invalid GTs, degenerate boxes) and ``_pair_edge_cases``:
    IoUs within 1e-5 of the twin's (the shoelace summed in another order),
    0 for invalid GTs and for a frame with no near pair, NaN for an index
    out of range of a valid GT, one launch each; some degenerate pairs take
    the ring routine (printed with ``-s``)."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.ops import rotated_iou_pairs as rip

    cases = chip_smoke.pair_cases(torch, dev, np.random.default_rng(8), None)
    for name, (anchors, idx, gt, gv) in cases.items():
        before = kernel_lib.LAUNCHES["rotated_iou_pairs"]
        got, slow = rip.rotated_iou_pairs_cuda(anchors, idx, gt, gv,
                                               count_slow=True)
        assert kernel_lib.LAUNCHES["rotated_iou_pairs"] == before + 1
        ref = rip.rotated_iou_pairs_plain(anchors, idx, gt)
        err = float((got - ref)[gv].abs().max())
        print(f"{name}: within {err:.3g}, ring routine {int(slow)} pairs")
        assert err <= chip_smoke.PP_IOU_TOL, name
        assert (got[~gv] == 0).all()
        if name == "degenerate":
            assert int(slow) > 0
        else:
            assert int((got >= 0.6).sum()) > 0
    for name, (anchors, idx, gt, gv) in _pair_edge_cases(
            np.random.default_rng(9), dev).items():
        before = kernel_lib.LAUNCHES["rotated_iou_pairs"]
        got = rip.rotated_iou_pairs_cuda(anchors, idx, gt, gv)
        assert kernel_lib.LAUNCHES["rotated_iou_pairs"] == before + 1
        n = anchors.shape[0]
        inside = (idx >= 0) & (idx < n)
        ref = rip.rotated_iou_pairs_plain(anchors, idx.clamp(0, n - 1), gt)
        ref = torch.where(gv[..., None], torch.where(inside, ref, torch.nan),
                          0.0)
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), ref.isnan()), name
        ok = ~ref.isnan()
        err = float((got - ref)[ok].abs().max())
        print(f"{name}: within {err:.3g}")
        assert err <= chip_smoke.PP_IOU_TOL, name
        if name == "K=1500":
            assert int((got > 0).sum()) > 1000
        elif name == "every GT invalid":
            assert (got == 0).all()
        elif name == "no near pair in frame 0":
            assert (got[0] == 0).all() and int((got[1] > 0).sum()) > 0
        else:
            assert int(got.isnan().sum()) > 0 and int((got > 0).sum()) > 0
    # candidate_ious dispatches by device: the twin on the CPU
    anchors, idx, gt, gv = cases["heavy overlap"]
    before = dict(kernel_lib.LAUNCHES)
    cpu = rip.candidate_ious(anchors.cpu(), idx.cpu(), gt.cpu(), gv.cpu())
    assert kernel_lib.LAUNCHES == before
    card = rip.candidate_ious(anchors, idx, gt, gv)
    assert float((card.cpu() - cpu)[gv.cpu()].abs().max()) <= \
        chip_smoke.PP_IOU_TOL


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_training_step_on_card_matches_cpu(dev, head):
    """One full-width training step (two frames of the synthetic street
    on a 64 x 64 grid) from the committed checkpoint's variables on the
    card and on the CPU (``chip_smoke.compare_steps``): num_pos exact,
    loss parts within 1e-3 relative, every gradient tensor within 2e-3
    of its largest entry (``chip_smoke.PP_STEP_GRAD_TOL``; the CPU's own
    spread under one-ulp changes of the weights and the points is
    printed with ``-s``; from random weights the step's gradients are
    too ill-conditioned in float32 for such a check: the pillars'
    max-pool routes them by near ties); the SSD step launches
    the assigner's kernel once, the center step none; two card steps give
    the same bits."""
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarGridConfig, PillarsConfig, pillars_state_from_flax)
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    grid = PillarGridConfig(x_range=(-10.24, 10.24), y_range=(-10.24, 10.24),
                            z_range=(-5.0, 1.5), pillar_size=0.32)
    cfg = PillarsConfig(grid=grid, head=head)
    rng = np.random.default_rng(6)
    pts, cars = chip_smoke.pillars_world(rng, 2 * 16384)
    near = (np.abs(cars[:, 0]) < 9) & (np.abs(cars[:, 1]) < 9)
    gt = np.zeros((2, 16, 7), np.float32)
    gv = np.zeros((2, 16), bool)
    gt[:, :near.sum()] = cars[near]
    gv[:, :near.sum()] = True
    points = np.stack([pts[:16384], pts[16384:]])
    batch = (points, np.ones(points.shape[:2], bool), gt,
             np.zeros((2, 16), np.int32), gv)
    state = pillars_state_from_flax(read_flax_msgpack(
        chip_smoke.PP_CKPTS[head])["0"])
    result = chip_smoke.compare_steps(torch, cfg, state, batch, dev)
    print(f"{head}: loss parts within {result[2]:.3g}, gradients within "
          f"{result[3]:.3g}, the CPU's spread {result[4]:.3g}")
    assert chip_smoke.steps_agree(*result[:4])
    assert result[0]["num_pos"] >= 1
    runs = []
    for _ in range(2):
        before = dict(kernel_lib.LAUNCHES)
        runs.append(chip_smoke.training_step_grads(torch, cfg, state, batch,
                                                   dev))
        launched = {k: kernel_lib.LAUNCHES[k] - before[k] for k in before}
        want = {k: 0 for k in before}
        if head == "ssd":
            want["rotated_iou_pairs"] = 1
        assert launched == want
    assert runs[0][0] == runs[1][0]
    assert chip_smoke.grad_spread(runs[1][1], runs[0][1]) == 0.0


def test_cli_training_runs_write_equal_checkpoints(dev, tmp_path):
    """``pointpillars-train --surround --aggregate-sweeps`` on the card
    (full width, the surround grid, 2 steps of 4 frames of 32768 points)
    run twice: byte-equal checkpoints and sidecars, the assigner's kernel
    once a step and the evaluation's rotated NMS once a frame; then
    ``pointpillars-infer --ckpt`` reads what was written."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib

    root = str(tmp_path / "tree")
    chip_smoke.pillars_tree(root, np.random.default_rng(2))
    for run in ("a", "b"):
        kernel_lib.reset_launches()
        chip_smoke.run_cli(["pointpillars-train", "--dataset", root,
                            "--surround", "--aggregate-sweeps", "--head",
                            "ssd", "--steps", "2", "--max-points", "32768",
                            "--checkpoint-dir", str(tmp_path / run),
                            "--device", str(dev)])
        assert kernel_lib.LAUNCHES["rotated_iou_pairs"] == 2
        assert kernel_lib.LAUNCHES["rotated_nms"] == len(chip_smoke.PP_FRAMES)
    assert chip_smoke.same_files(str(tmp_path / "b"), str(tmp_path / "a"),
                                 "the second training run") == 2
    text = chip_smoke.run_cli([
        "pointpillars-infer", "--dataset", root, "--ckpt",
        str(tmp_path / "a" / "pp_ssd_step2.msgpack"), "--surround",
        "--aggregate-sweeps", "--head", "ssd", "--max-points", "32768",
        "--output", str(tmp_path / "infer"), "--device", str(dev)])
    assert text.startswith(f"{len(chip_smoke.PP_FRAMES)} frames")


def test_pillar_ids_at_pillar_edges_equal_cpu(dev):
    """Points a few ulps either side of pillar edges get the CPU's pillar
    ids and features on the card: the pillar index divides by the pillar
    size as IEEE division (``voxelize.true_div``), where PyTorch's CUDA
    kernel would multiply by the reciprocal of a Python-scalar divisor and
    put some of them in the next pillar (-16.000011 on the surround grid
    was one)."""
    from lidar_object_detection_tpu_torch.models.pointpillars import (
        PillarsConfig, pillar_ids, point_features)

    grid = PillarsConfig.kitti360_surround().grid
    rng = np.random.default_rng(9)
    edges = grid.x_range[0] + grid.pillar_size * rng.integers(1, grid.nx,
                                                              4096)
    x = edges.astype(np.float32)
    for _ in range(4):       # up to 4 ulps either way
        step = rng.integers(-1, 2, 4096)
        x = np.where(step > 0, np.nextafter(x, np.float32(np.inf)),
                     np.where(step < 0, np.nextafter(x, np.float32(-np.inf)),
                              x)).astype(np.float32)
    pts = np.stack([x, x[::-1].copy(), np.full(4096, -1.7, np.float32),
                    rng.uniform(0, 1, 4096).astype(np.float32)], 1)
    pts[0, :2] = -16.000011444091797
    points = torch.from_numpy(pts)
    valid = torch.ones(4096, dtype=torch.bool)
    ids, ok = pillar_ids(points, valid, grid)
    ids_card, ok_card = pillar_ids(points.to(dev), valid.to(dev), grid)
    assert torch.equal(ids_card.cpu(), ids) and torch.equal(ok_card.cpu(), ok)
    feats, _, _ = point_features(points, valid, grid)
    feats_card, _, _ = point_features(points.to(dev), valid.to(dev), grid)
    assert float((feats_card.cpu() - feats).abs().max()) < 1e-4
