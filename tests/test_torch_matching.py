"""The port's V4/V5 matching against the JAX package's, on the CPU.

The same seeded numpy inputs go to both packages: the assignment solvers
(``ops/lap.py``'s twin and ``ops/hungarian.py``) at small shapes and at
V5's 32 x 384, the box projection and the axis-aligned test, the V4
greedy-IoU and V5 Hungarian matchers, the analysis cloud's inside labels,
and the runner's V4 and V5 runs with the stub detector on a synthetic
KITTI-360 tree written into a temporary directory.  The scenes hold real
boxes that are not visible (behind the camera, off the image, straddling
the image plane), so that V4's visible boxes and V5's real boxes differ.

Tolerances: none for indices, assignments and words (bit-equal); 1e-6
absolute for IoUs and scores (float32 in both packages, the same
operations; JAX's are given float32 arrays, since the tests run JAX with
x64); 1e-5 for the average corner depth, a float32 sum of 8 taken in
another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import chip_smoke
from lidar_object_detection_tpu import config as jconfig
from lidar_object_detection_tpu.config import FusionConfig as JFusionConfig
from lidar_object_detection_tpu.config import PipelineVersion as JVersion
from lidar_object_detection_tpu.data.kitti360 import (
    Kitti360Dataset as JDataset)
from lidar_object_detection_tpu.fusion import associate as jassoc
from lidar_object_detection_tpu.geom import boxes as jboxes
from lidar_object_detection_tpu.ops.hungarian import hungarian as jhungarian
from lidar_object_detection_tpu.ops.lap import lap as jlap
from lidar_object_detection_tpu.pipelines import runner as jrunner
from lidar_object_detection_tpu_torch.config import (
    FusionConfig, PipelineVersion, ShapeConfig)
from lidar_object_detection_tpu_torch.data import Kitti360Dataset
from lidar_object_detection_tpu_torch.fusion import associate
from lidar_object_detection_tpu_torch.geom import boxes
from lidar_object_detection_tpu_torch.ops.hungarian import hungarian
from lidar_object_detection_tpu_torch.ops.lap import lap, lap_plain
from lidar_object_detection_tpu_torch.pipelines import runner

H, W = 64, 192
K = np.array([[90.0, 0.0, 96.0], [0.0, 90.0, 32.0], [0.0, 0.0, 1.0]])
SHAPES = dict(max_points=4096, max_detections=8, max_boxes=48,
              image_height=H, image_width=W)
SMALL, JSMALL = ShapeConfig(**SHAPES), jconfig.ShapeConfig(**SHAPES)
D, G = 8, 48
T = torch.from_numpy
J = jnp.asarray


def hidden_boxes():
    """Real boxes no camera test keeps: behind the camera, off the image
    to the right, and one straddling the image plane (some corners
    behind, some in front)."""
    return np.stack([
        chip_smoke.box_corners(np.array([0.0, 1.6, -8.0]), (1.8, 1.5, 4.2),
                               0.3),
        chip_smoke.box_corners(np.array([40.0, 1.6, 10.0]), (1.8, 1.5, 4.2),
                               0.0),
        chip_smoke.box_corners(np.array([1.0, 1.6, 0.5]), (1.8, 1.5, 4.2),
                               0.2)])


def make_frame(rng, n_det=4, num_valid=16):
    """One frame: velodyne points (N, 4) and cam0 corners (G', 8, 3) of
    ``num_valid`` boxes in front (those behind ``n_det`` detections filled
    with points) and the three hidden boxes."""
    x1 = rng.uniform(0, W - 50, n_det)
    y1 = rng.uniform(8, H - 30, n_det)
    det = np.stack([x1, y1, x1 + rng.uniform(20, 45, n_det),
                    y1 + rng.uniform(12, 25, n_det)], -1)
    points, pvalid, corners, bvalid = chip_smoke.make_scene(
        rng, det, np.ones(n_det, bool), num_points=SHAPES["max_points"],
        num_boxes=G, num_valid=num_valid, intrinsics=K)
    return points[pvalid], np.concatenate([corners[bvalid],
                                           hidden_boxes()])


def write_tree(root, seed=0, frames=3):
    """Frames 100, 101, ... and frame 99 without a box JSON, images of
    noise; returns the root as a string."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(frames):
        points, corners = make_frame(rng)
        image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        out.append((100 + b, image, points, corners))
    out.append((99, out[0][1], out[0][2], None))
    chip_smoke.write_kitti360_tree(str(root), out, K, W, H)
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("matching_tree"))


def batch_inputs(rng, b=3):
    """Batched matcher inputs, float32: det boxes (B, D, 4) near the
    projected boxes (some far off), det validity, cam0 corners (B, G, 8,
    3) with hidden boxes, and a box mask."""
    corners = np.zeros((b, G, 8, 3), np.float32)
    box_valid = np.zeros((b, G), bool)
    dets = np.zeros((b, D, 4), np.float32)
    for i in range(b):
        _, c = make_frame(rng, n_det=5, num_valid=30)
        corners[i, :len(c)] = c
        box_valid[i, :len(c)] = True
        bbox = np.asarray(jboxes.project_boxes_to_2d(
            J(c.astype(np.float32)), J(K.astype(np.float32)))["bbox"])
        pick = rng.choice(len(c) - 3, D, replace=False)
        dets[i] = bbox[pick] + rng.normal(0, 4, (D, 4))
        dets[i, -2:] = rng.uniform(0, W, (2, 4))        # no GT behind them
    dets = np.concatenate([np.minimum(dets[..., :2], dets[..., 2:]),
                           np.maximum(dets[..., :2], dets[..., 2:])], -1)
    det_valid = rng.random((b, D)) > 0.2
    return dets.astype(np.float32), det_valid, corners, box_valid


# ---------------------------------------------------------------------------
# the assignment solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,c,dense", [(1, 5, 1.0), (3, 10, 1.0),
                                       (8, 8, 0.7), (8, 48, 0.5),
                                       (32, 384, 0.1)])
def test_lap_plain_equals_jax_lap(r, c, dense):
    """col4row bit-equal to JAX's ``lap`` on every row, padded ones too;
    on the real rows its cost equals scipy's optimum."""
    rng = np.random.default_rng(r * 1000 + c)
    cost = (1.0 - rng.random((3, r, c))).astype(np.float32)
    cost[2] = np.round(cost[2] * 4) / 4                  # many exact ties
    row_mask = rng.random((3, r)) < max(dense, 0.4)
    row_mask[:, 0] = True
    col_mask = rng.random((3, c)) < dense
    col_mask[:, :r] = True
    got = lap_plain(T(cost), T(row_mask), T(col_mask)).numpy()
    assert got.dtype == np.int32 and got.shape == (3, r)
    for b in range(3):
        ref = np.asarray(jlap(J(cost[b]), J(row_mask[b]), J(col_mask[b])))
        np.testing.assert_array_equal(got[b], ref)
        rows = np.nonzero(row_mask[b])[0]
        cols = np.nonzero(col_mask[b])[0]
        real = cost[b][np.ix_(rows, cols)]
        sr, sc = linear_sum_assignment(real)
        assert set(got[b][rows].tolist()) <= set(cols.tolist())
        assert np.isclose(cost[b][rows, got[b][rows]].sum(),
                          real[sr, sc].sum(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("r,c", [(4, 9), (32, 384)])
def test_hungarian_equals_jax_exact(r, c):
    """The exact solver equals JAX's on the real rows, and the twin of the
    serving solver equals it there too."""
    rng = np.random.default_rng(7 + r)
    cost = (1.0 - rng.random((2, r, c))).astype(np.float32)
    row_mask = rng.random((2, r)) < 0.5
    row_mask[:, 0] = True
    col_mask = rng.random((2, c)) < 0.3
    col_mask[:, :r] = True
    got = hungarian(T(cost), T(row_mask), T(col_mask)).numpy()
    twin = lap_plain(T(cost), T(row_mask), T(col_mask)).numpy()
    for b in range(2):
        ref = np.asarray(jhungarian(J(cost[b]), J(row_mask[b]),
                                    J(col_mask[b])))
        rows = row_mask[b]
        np.testing.assert_array_equal(got[b][rows], ref[rows])
        np.testing.assert_array_equal(twin[b][rows], ref[rows])


def test_lap_dispatch_and_refusals():
    """``lap`` takes the twin on a CPU tensor, one frame or a batch, masks
    optional; more rows than columns is refused."""
    rng = np.random.default_rng(3)
    cost = rng.random((5, 12)).astype(np.float32)
    single = lap(T(cost))
    assert single.shape == (5,)
    np.testing.assert_array_equal(single.numpy(),
                                  np.asarray(jlap(J(cost))))
    np.testing.assert_array_equal(lap(T(cost)[None])[0].numpy(),
                                  single.numpy())
    col4row, scans = lap_plain(T(cost), return_scans=True)
    assert int(scans) >= 5 and torch.equal(col4row, single)
    with pytest.raises(ValueError, match="rows <= cols"):
        lap(T(cost.T.copy()))
    with pytest.raises(ValueError, match="rows <= cols"):
        hungarian(T(cost.T.copy()))


# ---------------------------------------------------------------------------
# geometry and the matchers
# ---------------------------------------------------------------------------

def test_project_boxes_to_2d_and_aabb_match_jax():
    rng = np.random.default_rng(5)
    _, c = make_frame(rng, n_det=5, num_valid=30)
    c = c.astype(np.float32)
    kf = K.astype(np.float32)
    got = boxes.project_boxes_to_2d(T(c), T(kf))
    ref = jboxes.project_boxes_to_2d(J(c), J(kf))
    for key in ("bbox", "center", "size", "area", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["avg_depth"].numpy(),
                               np.asarray(ref["avg_depth"]), rtol=0,
                               atol=1e-5)
    valid = got["valid"].numpy()
    assert valid.sum() >= 20 and not valid[-3]     # the box behind
    # a batch gives each frame's
    both = boxes.project_boxes_to_2d(T(np.stack([c, c[::-1].copy()])), T(kf))
    np.testing.assert_array_equal(both["bbox"][1].numpy(),
                                  got["bbox"].numpy()[::-1])

    pts = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    pts[:100] = c[rng.integers(0, len(c), 100), 0] + rng.normal(0, 1, (100, 3))
    mask = rng.random(len(c)) > 0.2
    inside = boxes.points_in_aabb(T(pts), T(c), T(mask)).numpy()
    np.testing.assert_array_equal(
        inside, np.asarray(jboxes.points_in_aabb(J(pts), J(c), J(mask))))
    assert inside.sum() > 0


def test_greedy_iou_match_matches_jax():
    dets, det_valid, corners, box_valid = batch_inputs(
        np.random.default_rng(11))
    kf = K.astype(np.float32)
    got_idx, got_iou = associate.greedy_iou_match(
        T(dets), T(det_valid), T(corners), T(box_valid), T(kf), 0.25)
    ref_idx, ref_iou = jax.vmap(
        lambda db, dv, c, bv: jassoc.greedy_iou_match(db, dv, c, bv, J(kf),
                                                      0.25))(
        J(dets), J(det_valid), J(corners), J(box_valid))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(ref_iou),
                               rtol=0, atol=1e-6)
    matched = got_idx.numpy() >= 0
    assert matched.sum() >= 6 and (~matched & det_valid).sum() >= 1


def test_matching_scores_match_jax():
    dets, _, corners, _ = batch_inputs(np.random.default_rng(12))
    kf = K.astype(np.float32)
    score, iou, valid = associate.matching_scores(T(dets), T(corners), T(kf))
    for b in range(len(dets)):
        rs, ri, rv = jassoc.matching_scores(J(dets[b]), J(corners[b]), J(kf))
        assert np.asarray(rs).dtype == np.float32
        np.testing.assert_allclose(score[b].numpy(), np.asarray(rs), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(iou[b].numpy(), np.asarray(ri), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(rv))


@pytest.mark.parametrize("solver", ["lap", "exact"])
def test_hungarian_match_matches_jax(solver):
    dets, det_valid, corners, box_valid = batch_inputs(
        np.random.default_rng(13))
    kf = K.astype(np.float32)
    got = associate.hungarian_match(T(dets), T(det_valid), T(corners),
                                    T(box_valid), T(kf), solver=solver)
    ref = jax.vmap(lambda db, dv, c, bv: jassoc.hungarian_match(
        db, dv, c, bv, J(kf), solver=solver))(
        J(dets), J(det_valid), J(corners), J(box_valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    matched = got[0].numpy() >= 0
    assert matched.sum() >= 6 and (~matched & det_valid).sum() >= 1
    with pytest.raises(ValueError, match="solver"):
        associate.hungarian_match(T(dets), T(det_valid), T(corners),
                                  T(box_valid), T(kf), solver="scipy")


def test_point_inside_labels_match_jax():
    rng = np.random.default_rng(14)
    b, p = 2, 4096
    points = np.zeros((b, p, 4), np.float32)
    words = np.zeros((b, p), np.uint32)
    corners_velo = np.zeros((b, G, 8, 3), np.float32)
    best_box = np.full((b, D), -1, np.int32)
    matched = np.zeros((b, D), bool)
    for i in range(b):
        pts, c = make_frame(rng, n_det=6, num_valid=20)
        points[i, :len(pts)] = pts
        corners_velo[i, :len(c)] = chip_smoke.to_velo(
            c.reshape(-1, 3)).reshape(-1, 8, 3)
        words[i] = rng.integers(0, 2 ** D, p) * (rng.random(p) < 0.7)
        best_box[i, :6] = rng.choice(len(c), 6, replace=False)
        best_box[i, 2] = -1
        matched[i] = best_box[i] >= 0
    got = associate.point_inside_labels(
        T(points), T(words.view(np.int32)), T(corners_velo), T(best_box),
        T(matched), D).numpy().view(np.uint32)
    for i in range(b):
        ref = np.asarray(jassoc.point_inside_labels(
            J(points[i]), J(words[i]), J(corners_velo[i]), J(best_box[i]),
            J(matched[i]), num_detections=D))
        np.testing.assert_array_equal(got[i], ref)
    assert (got != 0).sum() > 100


# ---------------------------------------------------------------------------
# the runner's V4 and V5
# ---------------------------------------------------------------------------

def _pipelines(tree, version):
    jcfg = dataclasses.replace(JFusionConfig.for_version(JVersion(version)),
                               shapes=JSMALL)
    cfg = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion(version)), shapes=SMALL)
    return (jrunner.FusionPipeline(JDataset(tree, shapes=JSMALL), jcfg),
            runner.FusionPipeline(Kitti360Dataset(tree, shapes=SMALL), cfg,
                                  device="cpu"))


def _same_pairs(got, ref):
    assert len(got) == len(ref)
    for p, q in zip(got, ref):
        assert list(p) == list(q)
        for key, value in q.items():
            if key == "corners_velo":
                np.testing.assert_array_equal(p[key], np.asarray(value))
            elif key in ("iou", "score"):
                assert abs(p[key] - value) <= 1e-6, (key, p[key], value)
            else:
                assert p[key] == value, key


@pytest.mark.parametrize("version", ["v4_iou", "v5_projected"])
def test_run_matches_jax(tree, version):
    """The runner's V4 and V5 runs with the stub detector: rows, matched
    pairs (V5's unmatched grey boxes too) and counts equal to JAX's.  V4
    matches against the visible boxes and V5 against every real box, and
    the tree's frames have real boxes that are not visible."""
    jpipe, tpipe = _pipelines(tree, version)
    ref, got = jpipe.run(), tpipe.run()
    assert [vars(r) for r in got.csv_rows] == [vars(r) for r in ref.csv_rows]
    n_pairs = n_unmatched = 0
    for a, b in zip(got.frames, ref.frames, strict=True):
        assert (a.frame_id, a.num_detections, a.num_visible_boxes) == \
            (b.frame_id, b.num_detections, b.num_visible_boxes)
        _same_pairs(a.matched_pairs, b.matched_pairs)
        n_pairs += sum(not p.get("unmatched") for p in a.matched_pairs)
        n_unmatched += sum(bool(p.get("unmatched")) for p in a.matched_pairs)
    assert n_pairs >= 6
    assert got.detections["boxes"].shape == (3, D, 4)
    records = tpipe.dataset.load_frames()
    batch = tpipe.dataset.make_batch(records)
    n_real = batch.box_valid.sum(axis=1)
    if version == "v4_iou":
        # the hidden boxes are real but not visible
        assert all(f.num_visible_boxes <= n - 3
                   for f, n in zip(got.frames, n_real))
        assert n_unmatched == 0
    else:
        assert [f.num_visible_boxes for f in got.frames] == n_real.tolist()
        assert n_unmatched + n_pairs == n_real.sum()


def test_v4_and_v5_entry_points(tree):
    for fn, version in ((runner.v4_iou, PipelineVersion.V4_IOU),
                        (runner.v5_projected, PipelineVersion.V5_PROJECTED)):
        pipe = fn(tree, device="cpu", shapes=SMALL)
        assert pipe.config.version == version
        assert pipe.device.type == "cpu"
    assert runner.v5_projected(tree, device="cpu").config.bbox_filter_enabled \
        is False
