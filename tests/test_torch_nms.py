"""Greedy NMS (K5): the port's plain twin against the JAX package's XLA
loop (``ops/nms.py``) and its Pallas kernel in interpret mode
(``ops/pallas_nms.py``), and the CUDA kernel against the twin on a card
(more card cases in ``test_torch_cuda.py``).  The JAX package is imported
only inside the tests that compare with it, so that the file collects on
a card's machine without JAX's libraries:

    python -m pytest tests/test_torch_nms.py -m cuda

The inputs come from ``chip_smoke.nms_case``: random float32 boxes with
heavy overlaps, NaN and infinite scores, invalid candidates, tied scores,
and pairs whose IoU sits exactly at the 0.7 threshold and one ulp to
either side.  Tolerance: none -- the keep flags and every index are equal.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops.nms import nms, nms_cuda, nms_plain

THR = 0.7


def _jax_frames(fn, boxes, scores, valid, m, **kw):
    import jax.numpy as jnp

    out = [fn(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
              jnp.asarray(valid[b]), THR, m, **kw)
           for b in range(len(boxes))]
    return (np.stack([np.asarray(i) for i, _ in out]).astype(np.int64),
            np.stack([np.asarray(k) for _, k in out]).astype(bool))


def _plain(boxes, scores, valid, m):
    idx, keep = nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid), THR, m)
    return idx.numpy(), keep.numpy()


@pytest.mark.parametrize("batch,n,m", [(1, 96, 32), (4, 64, 32),
                                       (2, 12, 20)])
def test_plain_matches_jax_nms(batch, n, m):
    from lidar_object_detection_tpu.ops.nms import nms as jnms

    boxes, scores, valid = chip_smoke.nms_case(
        np.random.default_rng(batch * 100 + n), batch, n, THR)
    idx, keep = _plain(boxes, scores, valid, m)
    ref_idx, ref_keep = _jax_frames(jnms, boxes, scores, valid, m)
    np.testing.assert_array_equal(keep, ref_keep)
    np.testing.assert_array_equal(idx, ref_idx)
    assert keep.any(axis=1).all()


@pytest.mark.parametrize("batch,n,m", [(2, 48, 16), (1, 12, 14)])
def test_plain_matches_pallas_interpret(batch, n, m):
    from lidar_object_detection_tpu.ops.pallas_nms import pallas_nms

    boxes, scores, valid = chip_smoke.nms_case(
        np.random.default_rng(7 + n), batch, n, THR)
    idx, keep = _plain(boxes, scores, valid, m)
    ref_idx, ref_keep = _jax_frames(pallas_nms, boxes, scores, valid, m,
                                    interpret=True)
    np.testing.assert_array_equal(keep, ref_keep)
    np.testing.assert_array_equal(idx[keep], ref_idx[ref_keep])


def test_both_views_in_one_call_equal_two_calls_and_pallas():
    """The decode runs NMS once over both TTA views (2B frames): slot for
    slot the two per-view calls, and the Pallas kernel frame by frame."""
    from lidar_object_detection_tpu.ops.pallas_nms import pallas_nms

    b, n, m = 3, 48, 16
    boxes, scores, valid = chip_smoke.nms_case(np.random.default_rng(21),
                                               2 * b, n, THR)
    valid[4] = False                      # a frame with nothing alive
    idx, keep = _plain(boxes, scores, valid, m)
    for view in (slice(0, b), slice(b, None)):
        v_idx, v_keep = _plain(boxes[view], scores[view], valid[view], m)
        np.testing.assert_array_equal(keep[view], v_keep)
        np.testing.assert_array_equal(idx[view], v_idx)
    ref_idx, ref_keep = _jax_frames(pallas_nms, boxes, scores, valid, m,
                                    interpret=True)
    np.testing.assert_array_equal(keep, ref_keep)
    np.testing.assert_array_equal(idx[keep], ref_idx[ref_keep])
    assert not keep[4].any() and keep.any(axis=1).sum() == 2 * b - 1


def test_near_threshold_pairs_decide_by_strict_greater():
    """The pair at the threshold and the one an ulp below both survive;
    the one an ulp above is suppressed."""
    boxes, scores, valid = chip_smoke.nms_case(np.random.default_rng(3), 1,
                                               40, THR)
    idx, keep = _plain(boxes, scores, valid, 40)
    kept = set(idx[0][keep[0]].tolist())
    base = 0
    assert {base, base + 1, base + 2, base + 3, base + 4} <= kept
    assert base + 5 not in kept


def test_single_frame_and_dispatch_on_cpu():
    boxes, scores, valid = chip_smoke.nms_case(np.random.default_rng(5), 3,
                                               32, THR)
    t = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    idx, keep = nms(*t, THR, 16)
    ref_idx, ref_keep = nms_plain(*t, THR, 16)
    assert torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)
    one_idx, one_keep = nms(t[0][1], t[1][1], t[2][1], THR, 16)
    assert one_idx.shape == (16,) and one_idx.dtype == torch.int64
    assert torch.equal(one_idx, idx[1]) and torch.equal(one_keep, keep[1])


def test_wrapper_raises_on_cpu_tensors_and_wrong_types():
    boxes, scores, valid = (torch.from_numpy(a) for a in chip_smoke.nms_case(
        np.random.default_rng(0), 2, 16, THR))
    before = dict(kernel_lib.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        nms_cuda(boxes, scores, valid, THR, 8)
    with pytest.raises(TypeError, match="float32"):
        nms_cuda(boxes.double(), scores, valid, THR, 8)
    with pytest.raises(TypeError, match="bool"):
        nms_cuda(boxes, scores, valid.to(torch.uint8), THR, 8)
    with pytest.raises(ValueError, match="contiguous"):
        nms_cuda(boxes, scores.t().contiguous().t(), valid, THR, 8)
    with pytest.raises(ValueError, match="1024"):
        nms_cuda(torch.zeros((1, 1025, 4)), torch.zeros((1, 1025)),
                 torch.zeros((1, 1025), dtype=torch.bool), THR, 8)
    assert kernel_lib.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_equals_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    boxes, scores, valid = (torch.from_numpy(a).cuda()
                            for a in chip_smoke.nms_case(
                                np.random.default_rng(11), 8, 256, THR))
    idx, keep = nms_cuda(boxes, scores, valid, THR, 32)
    ref_idx, ref_keep = nms_plain(boxes, scores, valid, THR, 32)
    torch.cuda.synchronize()
    assert torch.equal(keep, ref_keep)
    assert torch.equal(idx, ref_idx)
    # one launch over both views equals one launch per view
    before = kernel_lib.LAUNCHES["nms"]
    halves = [nms_cuda(boxes[sl], scores[sl], valid[sl], THR, 32)
              for sl in (slice(0, 4), slice(4, None))]
    assert kernel_lib.LAUNCHES["nms"] == before + 2
    assert torch.equal(torch.cat([h[0] for h in halves]), idx)
    assert torch.equal(torch.cat([h[1] for h in halves]), keep)
