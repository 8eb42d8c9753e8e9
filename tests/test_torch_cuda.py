"""The port's CUDA kernels and card paths against their plain twins, on a
card.  Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.

This file imports nothing of JAX, Flax or the JAX package, so that it
collects on the card's machine, which does not promise them:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: none.  Kernel and twin agree bit for bit (integer counts,
packed words, NMS slots), and a run on the card writes the rows a run on
the CPU writes.
"""

import dataclasses
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


def test_k1_inside_counts_equals_twin(dev):
    from lidar_object_detection_tpu_torch.geom.boxes import (
        transform_corners)
    from lidar_object_detection_tpu_torch.ops import inside_counts as ic

    rng = np.random.default_rng(0)
    d = 32
    dets = np.stack([np.array([x, 150, x + 120, 260], np.float32)
                     for x in np.linspace(50, 1250, d)])
    points, pvalid, corners_cam, bvalid = chip_smoke.make_scene(
        rng, dets, np.ones(d, bool))
    words = rng.integers(0, 2 ** 32, len(points), dtype=np.uint64)
    words = (words * pvalid).astype(np.uint32).view(np.int32)
    args = (torch.from_numpy(points[:, :3]).to(dev).contiguous(),
            torch.from_numpy(words).to(dev),
            transform_corners(torch.from_numpy(corners_cam),
                              torch.from_numpy(chip_smoke.CAM_TO_VELO)
                              ).to(dev).contiguous(),
            torch.from_numpy(bvalid).to(dev), d)
    got = ic.inside_counts_cuda(*args)
    ref = ic.inside_counts_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got[0].sum()) > 0


def test_k2_k3_mask_kernels_equal_twins(dev):
    from lidar_object_detection_tpu_torch.ops import mask_assembly as ma

    rng = np.random.default_rng(1)
    d, mh, mw, h, w = 32, 42, 160, 376, 1408
    yy = np.linspace(0, 1, mh)[None, :, None]
    xx = np.linspace(0, 1, mw)[None, None, :]
    f = rng.uniform(1, 8, (d, 1, 1))
    table = (1 / (1 + np.exp(-6 * np.sin(f * 3 * yy + f)
                             * np.cos(f * 2 * xx)))).astype(np.float32)
    x1 = rng.uniform(0, w - 100, d)
    y1 = rng.uniform(0, h - 60, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(40, 600, d),
                      y1 + rng.uniform(30, 300, d)], 1).astype(np.float32)
    ops = ma.prepare_operands(torch.from_numpy(table)[None].to(dev),
                              torch.from_numpy(boxes)[None].to(dev),
                              torch.from_numpy(rng.random((1, d)) > 0.2).to(
                                  dev), h, w, 0.99)
    assert torch.equal(ma.count_above_cuda(ops), ma.count_above_plain(ops))
    words = ma.assemble_masks_cuda(ops)
    assert torch.equal(words, ma.assemble_masks_plain(ops))
    assert bool((words != 0).any())


@pytest.mark.parametrize("batch,n,m", [(8, 256, 32), (3, 1024, 40),
                                       (2, 20, 32)])
def test_k5_nms_equals_twin(dev, batch, n, m):
    from lidar_object_detection_tpu_torch.ops.nms import nms_cuda, nms_plain

    boxes, scores, valid = (torch.from_numpy(a).to(dev)
                            for a in chip_smoke.nms_case(
                                np.random.default_rng(n), batch, n, 0.7))
    idx, keep = nms_cuda(boxes, scores, valid, 0.7, m)
    ref_idx, ref_keep = nms_plain(boxes, scores, valid, 0.7, m)
    torch.cuda.synchronize()
    assert torch.equal(keep, ref_keep)
    assert torch.equal(idx, ref_idx)
    assert bool(keep.any(dim=1).all())


def test_k5_frame_with_nothing_alive(dev):
    """A frame whose candidates are all invalid writes (0, False) in every
    slot, beside frames that pick."""
    from lidar_object_detection_tpu_torch.ops.nms import nms_cuda, nms_plain

    boxes, scores, valid = chip_smoke.nms_case(np.random.default_rng(3), 4,
                                               256, 0.7)
    valid[2] = False
    boxes, scores, valid = (torch.from_numpy(a).to(dev)
                            for a in (boxes, scores, valid))
    idx, keep = nms_cuda(boxes, scores, valid, 0.7, 32)
    ref_idx, ref_keep = nms_plain(boxes, scores, valid, 0.7, 32)
    torch.cuda.synchronize()
    assert torch.equal(keep, ref_keep) and torch.equal(idx, ref_idx)
    assert not bool(keep[2].any()) and not bool(idx[2].any())
    assert bool(keep[[0, 1, 3]].any(dim=1).all())


@pytest.mark.parametrize("batch,r,c,rows,cols", [
    (4, 32, 384, 0.4, 0.1), (3, 8, 48, 1.0, 0.5), (3, 32, 32, 1.0, 1.0),
    (2, 1, 7, 1.0, 0.5), (2, 32, 384, 0.4, 0.0), (2, 16, 100, 0.8, 0.5),
    (2, 32, 200, 0.6, 0.3), (2, 32, 500, 0.5, 0.2), (2, 32, 700, 0.5, 0.1),
    (2, 32, 1000, 0.5, 0.1), (2, 32, 1600, 0.5, 0.1),
    (2, 4, 3000, 1.0, 0.05)])
def test_lap_kernel_equals_twin(dev, batch, r, c, rows, cols):
    """The assignment solver's kernel against its twin, every row (padded
    ones too), in one launch per batch; ``lap`` on CUDA tensors launches
    it, one frame or a batch.  The widths cover every columns-per-lane
    instantiation of ``csrc/lap.cu`` (1, 2, 4, 8, 12, 16, 24, 32 in
    registers; shared memory past C = 1024, up to the widest C it takes at
    R = 32)."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.ops import lap as lap_lib

    cost, row_mask, col_mask = (torch.from_numpy(a).to(dev)
                                for a in chip_smoke.lap_case(
                                    np.random.default_rng(r + c), batch, r,
                                    c, rows, cols))
    before = kernel_lib.LAUNCHES["lap"]
    got = lap_lib.lap_cuda(cost, row_mask, col_mask)
    assert kernel_lib.LAUNCHES["lap"] == before + 1
    ref = lap_lib.lap_plain(cost, row_mask, col_mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert torch.equal(lap_lib.lap(cost[0], row_mask[0], col_mask[0]), ref[0])
    assert kernel_lib.LAUNCHES["lap"] == before + 2


@pytest.mark.parametrize("c", [6, 70, 1100])
def test_lap_signed_zero_ties_go_to_the_lowest_column(dev, c):
    """Costs of -0.0 and +0.0 tie (as jnp.argmin has them): kernel and twin
    give each row the lowest free column among its tied zeros, whichever
    sign comes first.  A candidate is ((min_val + cost) - u) - v with
    min_val +0.0 at a phase's start, so a -0.0 cost becomes a +0.0
    candidate; the kernel keys every value as v + 0.0 besides."""
    from lidar_object_detection_tpu_torch.ops import lap as lap_lib

    r = 5
    cost = np.ones((2, r, c), np.float32)
    for i in range(r):
        cost[0, i, i::r] = 0.0
        cost[0, i, i::2 * r] = -0.0        # -0.0 first in every row
        cost[1, i, i::r] = 0.0             # +0.0 first in every row
        cost[1, i, i + r::2 * r] = -0.0
    cost, rows, cols = (torch.from_numpy(a).to(dev) for a in (
        cost, np.ones((2, r), bool), np.ones((2, c), bool)))
    got = lap_lib.lap_cuda(cost, rows, cols)
    ref = lap_lib.lap_plain(cost, rows, cols)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    want = torch.arange(r, dtype=torch.int32, device=dev)
    assert torch.equal(got, torch.stack([want, want]))
    assert bool(torch.signbit(cost[0, 0, 0])) and not bool(
        torch.signbit(cost[0, 0, r]))
    assert not bool(torch.signbit(cost[1, 0, 0])) and bool(
        torch.signbit(cost[1, 0, r]))


def test_lap_kernel_refuses_what_it_does_not_take(dev):
    from lidar_object_detection_tpu_torch.ops import lap as lap_lib

    cost = torch.rand((2, 4, 6), device=dev)
    rows = torch.ones((2, 4), dtype=torch.bool, device=dev)
    cols = torch.ones((2, 6), dtype=torch.bool, device=dev)
    with pytest.raises(TypeError):
        lap_lib.lap_cuda(cost.double(), rows, cols)
    with pytest.raises(ValueError, match="rows <= cols"):
        lap_lib.lap_cuda(cost.transpose(1, 2).contiguous(), cols, rows)
    with pytest.raises(ValueError, match="CUDA"):
        lap_lib.lap_cuda(cost.cpu(), rows.cpu(), cols.cpu())
    with pytest.raises(RuntimeError, match="CUDA error"):
        big = torch.rand((1, 32, 4096), device=dev)   # over shared memory
        lap_lib.lap_cuda(big, rows[:1].new_ones((1, 32)),
                         cols[:1].new_ones((1, 4096)))


def test_k1_batch_edge_cases_equal_twin(dev):
    """K1 in one launch on the edge cases of the smoke: P not a multiple of
    the kernel's rounds, D < 32, no active point, one box, every box
    invalid, points exactly on box faces, boxes whose edges are not
    orthogonal (whose slabs reach past the corners' bounds)."""
    from lidar_object_detection_tpu_torch.ops import inside_counts as ic

    rng = np.random.default_rng(4)
    pts, words, corners, mask = chip_smoke.face_case(rng)
    t = lambda a: torch.from_numpy(np.stack([a, a])).to(dev)
    args = [t(pts), t(words), t(corners), t(mask)]
    cases = [(args, 32), (args, 5), (args, 1),
             ([args[0], torch.zeros_like(args[1])] + args[2:], 32),
             (args[:2] + [args[2][:, :1].contiguous(),
                          args[3][:, :1].contiguous()], 32),
             (args[:3] + [torch.zeros_like(args[3])], 32)]
    skewed = [chip_smoke.skew_case(rng, c) for c in (0.4, 3e-4)]
    cases.append(([torch.from_numpy(np.stack([f[i] for f in skewed])).to(dev)
                   for i in range(4)], 32))
    for case, d in cases:
        got = ic.inside_counts_cuda(*case, d)
        ref = ic.inside_counts_plain(*case, d)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert int(ic.inside_counts_cuda(*args, 32)[0].sum()) > 0


def test_decode_with_k5_equals_decode_with_twin(dev):
    """The YOLO decode on the card, its NMS as K5 and as the twin."""
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        postprocess_batch)
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    frame = read_png_rgb(chip_smoke.FRAMES[0])
    images = np.ascontiguousarray(np.stack([frame, frame[:, ::-1]]))
    det, _, _ = load_serving_checkpoint(chip_smoke.CKPT, (376, 1408),
                                        device=dev)
    outputs = det.forward(images)
    got = postprocess_batch(outputs, det.params)
    ref = postprocess_batch(outputs, dataclasses.replace(det.params,
                                                         nms_impl="plain"))
    torch.cuda.synchronize()
    for key in ("boxes", "scores", "det_valid", "mask_bits"):
        assert torch.equal(got[key], ref[key])
    assert int(got["det_valid"].sum()) > 0


def test_csv_eval_on_card_writes_the_cpu_rows(dev, tmp_path):
    """The stub detector's csv_eval from a KITTI-360 tree: the card (K1)
    and the CPU (the twin) write the same master CSV."""
    from lidar_object_detection_tpu_torch.config import ShapeConfig
    from lidar_object_detection_tpu_torch.pipelines.runner import csv_eval

    k = np.array([[140.0, 0.0, 160.0], [0.0, 140.0, 48.0], [0, 0, 1.0]])
    rng = np.random.default_rng(2)
    frames = []
    for fid in range(3):
        x1 = rng.uniform(0, 250, 5)
        y1 = rng.uniform(10, 50, 5)
        dets = np.stack([x1, y1, x1 + 60, y1 + 35], 1)
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, dets, np.ones(5, bool), num_points=8192, num_boxes=48,
            num_valid=40, intrinsics=k)
        frames.append((fid, np.zeros((96, 320, 3), np.uint8),
                       points[pvalid], corners[bvalid]))
    root = str(tmp_path / "kitti360")
    chip_smoke.write_kitti360_tree(root, frames, k, 320, 96)
    shapes = ShapeConfig(max_points=8192, max_boxes=48, image_height=96,
                         image_width=320)
    paths = {}
    for name in ("cuda", "cpu"):
        paths[name] = os.path.join(str(tmp_path), f"{name}.csv")
        csv_eval(root, paths[name], device=name, timestamp="t",
                 shapes=shapes)
    with open(paths["cuda"]) as a, open(paths["cpu"]) as b:
        card, cpu = a.read(), b.read()
    assert card == cpu and len(card.splitlines()) > 5


def test_mask_kernels_at_odd_widths_equal_twins(dev):
    """K3, K2 (plain cut and the serving guard) and the peak pass on
    ``chip_smoke.odd_width_cases`` (KITTI's 1242 and 1241 and a width of 3
    mod 4, boxes on the last quad's columns and clamped to the width):
    counts, words and peak bits equal the twins'."""
    from lidar_object_detection_tpu_torch.ops import mask_assembly as ma

    rng = np.random.default_rng(5)
    for name, (h, w, arrays) in chip_smoke.odd_width_cases(rng).items():
        table, boxes, valid = (torch.from_numpy(a).to(dev) for a in arrays)
        ops = ma.prepare_operands(table, boxes, valid, h, w, 0.99)
        counts = ma.count_above_cuda(ops)
        assert torch.equal(counts, ma.count_above_plain(ops)), name
        for guard in (None, ma.Guard(counts, 0.5, 200)):
            assert torch.equal(ma.assemble_masks_cuda(ops, guard),
                               ma.assemble_masks_plain(ops, guard)), name
        assert torch.equal(ma.peak_cuda(ops).view(torch.int32),
                           ma.peak_plain(ops).view(torch.int32)), name
        if name.startswith(("dense", "last quad")):
            assert int(counts.sum()) > 0, name


def _peak_edge_cases(rng):
    """Operands of the peak pass where its work items are few, many or
    none: name -> (h, w, (table, boxes, valid)).  No valid detection in
    any frame; all 32 slots valid, each box the whole frame (and a
    frame's worth of items a box); all 32 valid at the dense sizes;
    one-pixel boxes (integer and half-pixel edges, at the frame's
    corners); the whole frame and one-pixel boxes at odd widths."""
    h, w = chip_smoke.H0, chip_smoke.W0
    table = chip_smoke.mask_table(rng, 2, 32, 42, 160)
    dense = chip_smoke.mask_cases(rng)["dense B=4"]
    whole = np.tile(np.array([0, 0, w, h], np.float32), (2, 32, 1))

    def pixels(h, w):
        b = np.tile(np.array([7, 9, 8, 10], np.float32), (2, 32, 1))
        b[:, 1] = [0, 0, 1, 1]
        b[:, 2] = [w - 1, h - 1, w, h]
        b[:, 3] = [10.5, 20.5, 11.5, 21.5]
        b[:, 4] = [w - 1.5, 3.25, w - 0.5, 4.25]
        b[:, 5:] += rng.integers(0, 300, (2, 27, 1)).astype(np.float32)
        return b

    out = {"no valid detection": (h, w, (table, whole,
                                         np.zeros((2, 32), bool))),
           "whole frame, D=32 valid": (h, w, (table, whole,
                                              np.ones((2, 32), bool))),
           "dense, D=32 valid": (h, w, (dense[0], dense[1],
                                        np.ones((4, 32), bool))),
           "one pixel": (h, w, (table, pixels(h, w),
                                np.ones((2, 32), bool)))}
    for oh, ow in chip_smoke.ODD_SHAPES:
        out[f"whole frame {oh}x{ow}"] = (
            oh, ow, (table, np.tile(np.array([0, 0, ow, oh], np.float32),
                                    (2, 32, 1)), np.ones((2, 32), bool)))
        out[f"one pixel {oh}x{ow}"] = (oh, ow, (table, pixels(oh, ow),
                                                np.ones((2, 32), bool)))
    return out


def test_peak_pass_equals_twin(dev):
    """The relative cut's peak pass (``mask_peak_kernel``) against its
    twin on ``chip_smoke.mask_cases`` and on ``_peak_edge_cases`` (no
    item, one item a box, whole frames, odd widths): float bits equal,
    one launch each; 0 for invalid and empty detections."""
    from lidar_object_detection_tpu_torch.ops import kernel_lib
    from lidar_object_detection_tpu_torch.ops import mask_assembly as ma

    rng = np.random.default_rng(4)
    cases = {name: (chip_smoke.H0, chip_smoke.W0, arrays)
             for name, arrays in chip_smoke.mask_cases(rng).items()}
    cases.update(_peak_edge_cases(rng))
    for name, (h, w, arrays) in cases.items():
        table, boxes, valid = (torch.from_numpy(a).to(dev) for a in arrays)
        ops = ma.prepare_operands(table, boxes, valid, h, w, 0.0)
        before = kernel_lib.LAUNCHES["mask_peak"]
        got = ma.peak_cuda(ops)
        assert kernel_lib.LAUNCHES["mask_peak"] == before + 1
        ref = ma.peak_plain(ops)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
            name
        assert (got[~valid] == 0).all(), name
        if name.startswith(("dense", "whole", "one pixel")):
            assert int((got > 0).sum()) > 10, name
        if name == "no valid detection":
            assert not got.any()


def _decode_modes():
    return {"logit": dict(mask_upsample="logit", mask_threshold=0.9),
            "relative": dict(mask_threshold_mode="relative",
                             mask_threshold=0.5),
            "coef": dict(mask_threshold=0.5, emit_coef=True)}


def test_decode_modes_on_card_equal_cpu(dev):
    """The n network's raw outputs on the card decoded on the card (the
    peak pass, K2, K5) and on the CPU (the twins): equal words; and the
    detection-only outputs give zero words on both."""
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        PostprocessParams, postprocess_batch)
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    images = np.stack([read_png_rgb(p) for p in chip_smoke.FRAMES])
    det, _, _ = load_serving_checkpoint(chip_smoke.CKPT, (376, 1408),
                                        tta="none", device=dev)
    outputs = det.forward(images)
    cpu = {k: [x.cpu() for x in v] if isinstance(v, list) else v.cpu()
           for k, v in outputs.items()}
    for name, kw in _decode_modes().items():
        params = PostprocessParams(spec=det.spec, **kw)
        got = postprocess_batch(outputs, params)
        ref = postprocess_batch(cpu, params)
        assert torch.equal(got["det_valid"].cpu(), ref["det_valid"]), name
        assert torch.equal(got["mask_bits"].cpu(), ref["mask_bits"]), name
        assert bool((ref["mask_bits"] != 0).any()), name
    det_only = {k: outputs[k] for k in ("box", "cls")}
    got = postprocess_batch(det_only, PostprocessParams(spec=det.spec))
    assert got["mask_bits"].shape == (2, 376, 1408)
    assert not bool(got["mask_bits"].any())


def test_kitti2d_on_card_equals_cpu(dev, tmp_path):
    """The KITTI 2D evaluation with its default detector (YOLO11x's
    detection head, random weights from seed 0) on the card and on the
    CPU: equal TP / FP / FN."""
    from lidar_object_detection_tpu_torch.pipelines.kitti2d import (
        run_kitti2d_eval)
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    frame = read_png_rgb(chip_smoke.FRAMES[0])
    samples = [(f"{i:06d}", np.ascontiguousarray(frame[:h, :w]),
                [("Car", 400.0, 170.0, 520.0, 240.0, 20.0)],
                chip_smoke.INTRINSICS)
               for i, (h, w) in enumerate(chip_smoke.KITTI2D_SHAPES[:2])]
    root = str(tmp_path / "tree")
    chip_smoke.write_kitti2d_tree(root, samples)
    card = run_kitti2d_eval(root, output_dir=str(tmp_path / "card"),
                            device=dev)
    cpu = run_kitti2d_eval(root, output_dir=str(tmp_path / "cpu"),
                           device="cpu")
    assert {k: card.totals[k] for k in ("tp", "fp", "fn")} == \
        {k: cpu.totals[k] for k in ("tp", "fp", "fn")}
