"""The port's rotated BEV IoU and its rotated-NMS twin against the JAX
package (``ops/rotated_iou.py``, ``models/pointpillars/decode.py``
``_rotated_nms``), on seeded numpy boxes.

Tolerances: the IoU matrix on tensors within 1e-5 of JAX's float32 one
(the same clip, the shoelace summed in another order, and cos/sin of
another library); the NumPy copy equal to JAX's NumPy twin (the same
float64 code).  NMS picks equal JAX's exactly; the inputs are checked to
hold no deciding IoU within 1e-5 of the threshold, where float32 rounding
could decide otherwise.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_object_detection_tpu.models.pointpillars.decode import (
    _rotated_nms as jax_rotated_nms)
from lidar_object_detection_tpu.ops import rotated_iou as jri
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops import rotated_iou as tri
from lidar_object_detection_tpu_torch.ops import rotated_nms as trn

IOU_TOL = 1e-5
# one candidate count for every JAX call here: JAX runs these eagerly, as
# its decode does, and compiles each primitive for each new shape
N = 96


def random_boxes(rng, n, spread=6.0):
    """(n, 7) float32 boxes: car-sized, any yaw, clustered so that many
    pairs overlap; a few exact copies and a few 90-degree turns."""
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-spread, spread, n)
    b[:, 1] = rng.uniform(-spread, spread, n)
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3] = rng.uniform(1.4, 2.2, n)
    b[:, 4] = rng.uniform(3.2, 5.0, n)
    b[:, 5] = rng.uniform(1.3, 1.8, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[1] = b[0]
    b[3] = b[2]
    b[3, 6] = b[2, 6] + np.float32(np.pi / 2)
    return b


def test_bev_corners_match_jax(rng):
    boxes = random_boxes(rng, 40)
    got = tri.box7_to_bev_corners(torch.from_numpy(boxes)).numpy()
    ref = np.asarray(jri.box7_to_bev_corners(jnp.asarray(boxes)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("spread", [2.0, 6.0, 30.0])
def test_rotated_iou_matrix_matches_jax(rng, spread):
    a = random_boxes(rng, N, spread)
    b = np.concatenate([a[:5], random_boxes(rng, N - 5, spread)])
    got = tri.rotated_iou_matrix(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()
    ref = np.asarray(jri.rotated_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (N, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=IOU_TOL)
    # identical boxes overlap fully; some pairs overlap partly
    assert np.allclose(np.diag(got[:5, :5]), 1.0, atol=IOU_TOL)
    assert ((got > 0.05) & (got < 0.95)).sum() > 0


def test_rotated_iou_matrix_blocks_rows(rng):
    """Clipping a block of rows at a time gives the whole matrix's rows."""
    a = random_boxes(rng, tri.ROW_BLOCK * 2 + 5)
    b = random_boxes(rng, 9)
    whole = tri.rotated_iou_matrix(torch.from_numpy(a), torch.from_numpy(b))
    rows = torch.cat([tri.rotated_iou_matrix(torch.from_numpy(a[i:i + 1]),
                                             torch.from_numpy(b))
                      for i in range(len(a))])
    assert torch.equal(whole, rows)


def test_rotated_iou_matrix_np_matches_jax_twin(rng):
    a = random_boxes(rng, 23)
    b = random_boxes(rng, 11)
    got = tri.rotated_iou_matrix_np(a, b)
    ref = jri.rotated_iou_matrix_np(a, b)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    assert tri.rotated_iou_matrix_np(a[:0], b).shape == (0, 11)


def nms_inputs(rng, n, kind):
    boxes = random_boxes(rng, n, spread=8.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = scores > 0.2
    if kind == "ties":
        scores = np.round(scores * 4).astype(np.float32) / 4
    elif kind == "nan":
        scores[rng.choice(n, n // 8, replace=False)] = np.nan
        scores[0] = np.inf
    elif kind == "invalid":
        valid[:] = False
    elif kind == "dense":
        boxes[:, :2] *= 0.15
        valid[:] = True
    return boxes, scores, valid


def deciding_gap(boxes, thr=0.5):
    """Smallest |IoU - thr| over all pairs: a lower bound of the gap of
    any IoU the greedy loop compares."""
    iou = jri.rotated_iou_matrix_np(boxes, boxes)
    return float(np.abs(iou - thr).min())


@pytest.mark.parametrize("kind", ["plain", "ties", "nan", "invalid",
                                  "dense"])
def test_rotated_nms_plain_matches_jax(rng, kind):
    n, m = N, 32
    boxes, scores, valid = nms_inputs(rng, n, kind)
    assert deciding_gap(boxes) > IOU_TOL
    idx, keep = trn.rotated_nms_plain(torch.from_numpy(boxes),
                                      torch.from_numpy(scores),
                                      torch.from_numpy(valid), 0.5, m)
    ref_idx, ref_keep = jax_rotated_nms(jnp.asarray(boxes),
                                        jnp.asarray(scores),
                                        jnp.asarray(valid), 0.5, m)
    assert idx.dtype == torch.int32 and keep.dtype == torch.bool
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref_keep))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    if kind == "invalid":
        assert not keep.any()
    elif kind == "dense":
        # every candidate valid, yet suppression empties the frame early
        assert 1 < int(keep.sum()) < m


def test_rotated_nms_plain_batches_frames_and_counts_pairs(rng):
    frames = [nms_inputs(rng, 64, kind) for kind in ("plain", "dense",
                                                     "invalid")]
    boxes, scores, valid = (torch.from_numpy(np.stack(a))
                            for a in zip(*frames))
    idx, keep, pairs = trn.rotated_nms_plain(boxes, scores, valid, 0.5, 12,
                                             return_pairs=True)
    assert idx.shape == keep.shape == (3, 12) and pairs.shape == (3,)
    for f in range(3):
        one = trn.rotated_nms_plain(boxes[f], scores[f], valid[f], 0.5, 12,
                                    return_pairs=True)
        assert torch.equal(one[0], idx[f]) and torch.equal(one[1], keep[f])
        assert int(one[2]) == int(pairs[f])
    # every pick sees at most the frame's other alive candidates
    alive0 = int((valid[0] & torch.isfinite(scores[0])).sum())
    assert 0 < int(pairs[0]) <= int(keep[0].sum()) * (alive0 - 1)
    assert int(pairs[2]) == 0


def test_rotated_nms_dispatches_cpu_to_twin_and_kernel_refuses_cpu(rng):
    boxes, scores, valid = (torch.from_numpy(a)
                            for a in nms_inputs(rng, 40, "plain"))
    before = dict(kernel_lib.LAUNCHES)
    got = trn.rotated_nms(boxes, scores, valid, 0.5, 8)
    ref = trn.rotated_nms_plain(boxes, scores, valid, 0.5, 8)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert kernel_lib.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        trn.rotated_nms_cuda(boxes[None], scores[None], valid[None], 0.5, 8)
