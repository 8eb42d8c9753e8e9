"""The PyTorch port's geometry, packed masks, erosion, fusion step and
per-car statistics against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port.  Integer outputs (counts, best boxes, packed words, rows) must be
equal; projected coordinates are compared in float64 to rtol 1e-12 (both
sides do the same float64 arithmetic, up to the order of a 3-term dot).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.eval import statistics as jstats
from lidar_object_detection_tpu.fusion.associate import (
    FusionParams as JFusionParams, fuse_batch as jfuse_batch,
    fuse_frame as jfuse_frame)
from lidar_object_detection_tpu.geom import boxes as jboxes
from lidar_object_detection_tpu.geom import projection as jproj
from lidar_object_detection_tpu.ops import erosion as jerosion
from lidar_object_detection_tpu.ops import masks as jmasks
from lidar_object_detection_tpu_torch.config import FusionParams
from lidar_object_detection_tpu_torch.eval import statistics as tstats
from lidar_object_detection_tpu_torch.fusion.associate import (
    fuse_batch, fuse_frame)
from lidar_object_detection_tpu_torch.geom import boxes as tboxes
from lidar_object_detection_tpu_torch.geom import projection as tproj
from lidar_object_detection_tpu_torch.ops import erosion as terosion
from lidar_object_detection_tpu_torch.ops import masks as tmasks
from tests.test_boxes import make_box

FIXTURE = "tests/fixtures/stub_detections_v1.npz"
H, W = 376, 1408
P, G, D = 8192, 48, 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(words):
    """JAX uint32 words (uint64 where x64 promoted a sum) as int32."""
    return np.asarray(words).astype(np.uint32).view(np.int32)


def _scene(seed=0, frame=0):
    """A float64 synthetic scan whose points fill 3D boxes behind the
    fixture's first D detections, plus scattered boxes and background."""
    rng = np.random.default_rng(seed)
    fx = np.load(FIXTURE)
    det_valid = fx["det_valid"][frame, :D]
    points, pvalid, corners, bvalid = chip_smoke.make_scene(
        rng, fx["boxes"][frame, :D], det_valid, num_points=P, num_boxes=G,
        num_valid=40)
    return dict(points=points.astype(np.float64), point_valid=pvalid,
                mask_bits=fx["mask_bits"][frame], det_valid=det_valid,
                corners=corners.astype(np.float64), box_valid=bvalid,
                velo_to_rect=chip_smoke.VELO_TO_RECT.astype(np.float64),
                cam_to_velo=chip_smoke.CAM_TO_VELO.astype(np.float64),
                intrinsics=chip_smoke.INTRINSICS.astype(np.float64))


def _run_both(s, erosion: bool, mode: str = "simple"):
    kw = dict(width=W, height=H, num_detections=D, erosion_enabled=erosion,
              bbox_filter_mode=mode)
    ref = jfuse_frame(
        jnp.asarray(s["points"]), jnp.asarray(s["point_valid"]),
        jnp.asarray(s["mask_bits"]), jnp.asarray(s["det_valid"]),
        jnp.asarray(s["corners"]), jnp.asarray(s["box_valid"]),
        jnp.asarray(s["velo_to_rect"]), jnp.asarray(s["cam_to_velo"]),
        jnp.asarray(s["intrinsics"]), params=JFusionParams(**kw))
    got = fuse_frame(
        _t(s["points"]), _t(s["point_valid"]), _t(_u32(s["mask_bits"])),
        _t(s["det_valid"]), _t(s["corners"]), _t(s["box_valid"]),
        _t(s["velo_to_rect"]), _t(s["cam_to_velo"]), _t(s["intrinsics"]),
        FusionParams(**kw))
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("erosion", [False, True])
def test_fuse_frame_matches_jax(erosion):
    s = _scene()
    ref, got = _run_both(s, erosion)
    for key in ("counts", "total_points", "best_box", "matched",
                "points_inside", "point_valid", "box_visible"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in ("point_bits", "eroded_mask_bits"):
        np.testing.assert_array_equal(got[key], _u32(ref[key]), err_msg=key)
    for key in ("u", "v", "depth"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12, atol=0,
                                   err_msg=key)
    np.testing.assert_allclose(got["corners_velo"], ref["corners_velo"],
                               rtol=1e-12, atol=1e-12)
    assert ref["matched"].sum() > 0 and ref["counts"].sum() > 0, \
        "degenerate scene: nothing matched"
    if erosion:
        assert (ref["eroded_mask_bits"] != s["mask_bits"]).any()


def test_fuse_frame_rich_filter_matches_jax():
    ref, got = _run_both(_scene(seed=1, frame=1), erosion=True, mode="rich")
    for key in ("counts", "best_box", "matched", "box_visible"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_fuse_batch_and_statistics_rows_match_jax():
    scenes = [_scene(seed=3, frame=f) for f in range(3)]
    kw = dict(width=W, height=H, num_detections=D, erosion_enabled=True)
    stack = lambda k: np.stack([s[k] for s in scenes])
    s0 = scenes[0]
    got = fuse_batch(
        _t(stack("points")), _t(stack("point_valid")),
        _t(_u32(stack("mask_bits"))), _t(stack("det_valid")),
        _t(stack("corners")), _t(stack("box_valid")),
        _t(s0["velo_to_rect"]), _t(s0["cam_to_velo"]),
        _t(s0["intrinsics"]), FusionParams(**kw))
    rows_t, rows_j = [], []
    for f, s in enumerate(scenes):
        ref, _ = _run_both(s, erosion=True)
        rows_j += jstats.frame_statistics(
            f, ref["total_points"], ref["best_box"], ref["points_inside"],
            ref["matched"], s["det_valid"], ref["box_visible"])
        rows_t += tstats.frame_statistics(
            f, got["total_points"][f], got["best_box"][f],
            got["points_inside"][f], got["matched"][f],
            _t(s["det_valid"]), got["box_visible"][f])
    assert [vars(r) for r in rows_t] == [vars(r) for r in rows_j]
    assert len(rows_t) > 0
    assert tstats.summarize(rows_t) == jstats.summarize(rows_j)


@pytest.mark.parametrize("erosion,mode", [(False, "simple"), (True, "rich")])
def test_batched_fuse_batch_matches_jax_fuse_batch(erosion, mode):
    """The port's fuse_batch runs every step over the frame axis at once
    (one inside-count call for the batch); the JAX fuse_batch vmaps
    fuse_frame.  Every output is equal, coordinates to float64 rounding."""
    scenes = [_scene(seed=11, frame=f) for f in range(3)]
    kw = dict(width=W, height=H, num_detections=D, erosion_enabled=erosion,
              bbox_filter_mode=mode)
    stack = lambda k: np.stack([s[k] for s in scenes])
    s0 = scenes[0]
    calib = [s0[k] for k in ("velo_to_rect", "cam_to_velo", "intrinsics")]
    ref = jfuse_batch(
        *(jnp.asarray(stack(k)) for k in ("points", "point_valid")),
        jnp.asarray(stack("mask_bits")),
        *(jnp.asarray(stack(k)) for k in ("det_valid", "corners",
                                          "box_valid")),
        *(jnp.asarray(c) for c in calib), params=JFusionParams(**kw))
    got = fuse_batch(
        _t(stack("points")), _t(stack("point_valid")),
        _t(_u32(stack("mask_bits"))), _t(stack("det_valid")),
        _t(stack("corners")), _t(stack("box_valid")),
        *(_t(c) for c in calib), FusionParams(**kw))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got.keys() == ref.keys()
    for key in ("counts", "total_points", "best_box", "matched",
                "points_inside", "point_valid", "box_visible"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in ("point_bits", "eroded_mask_bits"):
        np.testing.assert_array_equal(got[key], _u32(ref[key]), err_msg=key)
    for key in ("u", "v", "depth", "corners_velo"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12,
                                   atol=1e-12, err_msg=key)
    assert got["counts"].shape == (3, D, G)
    assert ref["matched"].sum() > 0


def test_geometry_matches_jax(rng):
    corners = np.stack([make_box(rng.uniform(-15, 15, 3), (2, 4.5, 1.7),
                                 rng.uniform(-3, 3)) for _ in range(20)])
    corners_cam = corners + np.array([0.0, 0.0, 20.0])
    corners_cam[3] = corners_cam[3] - np.array([0.0, 0.0, 40.0])  # behind
    k = chip_smoke.INTRINSICS.astype(np.float64)
    box_mask = rng.random(20) > 0.2
    for a, b in zip(jproj.cam2image(jnp.asarray(corners_cam), k),
                    tproj.cam2image(_t(corners_cam), _t(k))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)
    ja, jo = jboxes.box_frame(jnp.asarray(corners))
    ta, to = tboxes.box_frame(_t(corners))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-12)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(
        tboxes.corners_visibility(_t(corners_cam), _t(k), W, H,
                                  box_mask=_t(box_mask)).numpy(),
        np.asarray(jboxes.corners_visibility(
            jnp.asarray(corners_cam), k, W, H,
            box_mask=jnp.asarray(box_mask))))
    for a, b in zip(jboxes.corners_visibility_rich(
                        jnp.asarray(corners_cam), k, W, H),
                    tboxes.corners_visibility_rich(_t(corners_cam), _t(k),
                                                   W, H)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    pts = rng.uniform(-18, 18, (4096, 3))
    np.testing.assert_array_equal(
        tboxes.points_in_oriented_boxes(_t(pts), _t(corners),
                                        _t(box_mask)).numpy(),
        np.asarray(jboxes.points_in_oriented_boxes(
            jnp.asarray(pts), jnp.asarray(corners), jnp.asarray(box_mask))))
    xy = rng.uniform(0, 300, (12, 2))
    b2 = np.concatenate([xy, xy + rng.uniform(-20, 80, (12, 2))], 1)
    np.testing.assert_allclose(
        tboxes.iou_2d_matrix(_t(b2), _t(b2[::-1].copy())).numpy(),
        np.asarray(jboxes.iou_2d_matrix(jnp.asarray(b2),
                                        jnp.asarray(b2[::-1]))),
        rtol=1e-12)


def test_iou_2d_matrix_takes_a_batch_axis(rng):
    """A batch of frames' IoU matrices in one call equals the JAX IoU of
    each frame, and the port's per-frame call, exactly."""
    xy = rng.uniform(0, 300, (3, 10, 2)).astype(np.float32)
    a = np.concatenate([xy, xy + rng.uniform(-20, 80, (3, 10, 2))], -1)
    b = a[:, ::-1] + rng.normal(0, 5, a.shape).astype(np.float32)
    got = tboxes.iou_2d_matrix(_t(a), _t(b.copy()))
    assert got.shape == (3, 10, 10)
    for f in range(3):
        np.testing.assert_array_equal(
            got[f].numpy(),
            tboxes.iou_2d_matrix(_t(a[f]), _t(b[f].copy())).numpy())
        np.testing.assert_array_equal(
            got[f].numpy(), np.asarray(jboxes.iou_2d_matrix(
                jnp.asarray(a[f]), jnp.asarray(b[f]))))
    assert bool((got > 0).any())


def test_packed_masks_and_erosion_match_jax(rng):
    masks = rng.random((32, 40, 56)) > 0.3
    words = jmasks.pack_masks(masks)
    got = tmasks.pack_masks(_t(masks))
    np.testing.assert_array_equal(got.numpy(), _u32(words))
    np.testing.assert_array_equal(tmasks.unpack_masks(got, 32).numpy(),
                                  masks)
    for ksize, iters in ((3, 1), (5, 2)):
        np.testing.assert_array_equal(
            terosion.erode_packed(got, ksize, iters).numpy(),
            _u32(jerosion.erode_packed(jnp.asarray(words), ksize, iters)))
    u = rng.integers(-3, 60, 500).astype(np.float64)
    v = rng.integers(-3, 44, 500).astype(np.float64)
    valid = (u >= 0) & (u < 56) & (v >= 0) & (v < 40)
    np.testing.assert_array_equal(
        tmasks.gather_point_bits(got, _t(u), _t(v), _t(valid)).numpy(),
        _u32(jmasks.gather_point_bits(jnp.asarray(words), jnp.asarray(u),
                                      jnp.asarray(v), jnp.asarray(valid))))
    det_valid = rng.random(32) > 0.5
    det_valid[31] = True
    want = np.sum(np.where(det_valid, np.uint32(1) << np.arange(
        32, dtype=np.uint32), np.uint32(0)), dtype=np.uint32)
    assert int(tmasks.detection_word(_t(det_valid))) == \
        int(np.asarray(want).view(np.int32))
