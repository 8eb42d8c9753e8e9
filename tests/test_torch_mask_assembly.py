"""Stack-free mask assembly (kernels K2/K3 of the port) against the JAX
package: the Pallas kernels in interpret mode and the XLA resize path.

The plain twins interpolate with the same two taps per axis as the Pallas
kernels (``resize_taps``, pinned equal to JAX's here), y first then x,
each product and sum rounded on its own.  The XLA path resizes with dense
weight matrices instead, so the values may differ by 1-2 ulp and a pixel
within that distance of its cut could flip; the tests still require equal
words, as the JAX package's own Pallas tests do against XLA, because on
these inputs no pixel lies that close to a cut.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidar_object_detection_tpu.models.yolo.postprocess import (
    LetterboxSpec, _finish_masks as jfinish, cropped_prob_table as jtable)
from lidar_object_detection_tpu.ops import pallas_masks as pm
from lidar_object_detection_tpu_torch.models.yolo import postprocess as tpp
from lidar_object_detection_tpu_torch.ops import mask_assembly as ma
from lidar_object_detection_tpu_torch.ops.resize import resize_taps

H, W = 64, 256


def _u32(words):
    return np.asarray(words).astype(np.uint32).view(np.int32)


def _small_case(rng, d=8, mh=12, mw=40):
    """A (d, 12, 40) smooth probability table (half of it soft, so that a
    0.99 cut leaves some detections near-empty) and boxes in 64 x 256."""
    yy = np.linspace(0, 1, mh)[None, :, None]
    xx = np.linspace(0, 1, mw)[None, None, :]
    amp = np.where(np.arange(d) % 2, 9.0, 2.0)[:, None, None]
    phase = rng.uniform(0, 6, (d, 1, 1))
    table = 1 / (1 + np.exp(-amp * np.sin(5 * yy + phase)
                            * np.cos(7 * xx + phase)))
    x1 = rng.uniform(0, W - 40, d)
    y1 = rng.uniform(0, H - 20, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(20, 200, d),
                      y1 + rng.uniform(10, 50, d)], 1).astype(np.float32)
    det_valid = rng.random(d) > 0.2
    return table.astype(np.float32), boxes, det_valid


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_in,n_out", [(12, 64), (40, 256), (42, 376),
                                        (160, 1408), (13, 96)])
def test_resize_taps_equal_jax(n_in, n_out):
    ref = pm.resize_taps(n_in, n_out)
    got = resize_taps(n_in, n_out)
    for a, b in zip(ref[:3], got):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("threshold", [0.5, 0.99])
def test_twins_match_pallas_kernels(rng, threshold):
    table, boxes, det_valid = _small_case(rng)
    jargs = (jnp.asarray(table), jnp.asarray(boxes), jnp.asarray(det_valid),
             H, W)
    targs = (_t(table), _t(boxes), _t(det_valid), H, W)
    ref_words = pm.pallas_assemble_masks(*jargs, threshold=threshold,
                                         interpret=True)
    ref_counts = pm.pallas_count_above(*jargs, threshold=threshold,
                                       interpret=True)
    got_words = ma.assemble_masks(*targs, threshold)
    got_counts = ma.count_above(*targs, threshold)
    np.testing.assert_array_equal(got_words.numpy(), _u32(ref_words))
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(ref_counts))
    assert np.asarray(ref_counts).sum() > 0


def test_guarded_twin_matches_pallas_and_xla(rng):
    table, boxes, det_valid = _small_case(rng)
    kw = dict(threshold=0.99, floor=0.5, min_pixels=200)
    ref_pallas = pm.pallas_assemble_masks_guarded(
        jnp.asarray(table), jnp.asarray(boxes), jnp.asarray(det_valid), H, W,
        interpret=True, **kw)
    spec = LetterboxSpec.build(H, W, 640)
    ref_xla = jfinish(jnp.asarray(table), jnp.asarray(boxes),
                      jnp.asarray(det_valid), spec, impl="xla", **kw)
    got = ma.assemble_masks_guarded(_t(table), _t(boxes), _t(det_valid), H,
                                    W, 0.99, 0.5, 200)
    np.testing.assert_array_equal(got.numpy(), _u32(ref_pallas))
    np.testing.assert_array_equal(got.numpy(), _u32(ref_xla))
    plain_hi = ma.assemble_masks(_t(table), _t(boxes), _t(det_valid), H, W,
                                 0.99)
    assert (got != plain_hi).any(), "degenerate: the guard never fired"
    assert (got != 0).any()


@pytest.mark.parametrize("threshold,floor", [(0.5, None), (0.99, None),
                                             (0.99, 0.5)])
def test_finish_masks_matches_jax_xla_path(rng, threshold, floor):
    table, boxes, det_valid = _small_case(rng, d=6)
    spec_j = LetterboxSpec.build(H, W, 640)
    kw = dict(threshold=threshold, floor=floor,
              min_pixels=200 if floor is not None else 0)
    ref = jfinish(jnp.asarray(table), jnp.asarray(boxes),
                  jnp.asarray(det_valid), spec_j, impl="xla", **kw)
    params = tpp.PostprocessParams(
        spec=tpp.LetterboxSpec.build(H, W, 640), mask_threshold=threshold,
        mask_threshold_floor=floor, mask_min_pixels=kw["min_pixels"])
    got = tpp._finish_masks(_t(table), _t(boxes), _t(det_valid), params)
    np.testing.assert_array_equal(got.numpy(), _u32(ref))


def test_twin_serves_tta_consensus_table(rng):
    """Mirror of the JAX package's ``test_kernel_serves_tta_consensus_table``
    at the full 376 x 1408 frame: an averaged, width-mirrored proto-res
    table at the guarded serving point, against the XLA tail."""
    h0, w0 = 376, 1408
    spec = LetterboxSpec.build(h0, w0, 640)
    mh, mw = spec.dst_h // 4, spec.dst_w // 4
    d = 32
    protos = rng.normal(0, 1.0, (mh, mw, 32)).astype(np.float32)
    protos_b = rng.normal(0, 1.0, protos.shape).astype(np.float32)
    coef = rng.normal(0, 0.6, (d, 32)).astype(np.float32)
    coef = coef * np.where(np.arange(d)[:, None] % 2, 1.0, 0.1)
    x1 = rng.uniform(0, w0 - 60, d)
    y1 = rng.uniform(0, h0 - 40, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(20, 500, d),
                      y1 + rng.uniform(15, 200, d)], 1).astype(np.float32)
    det_valid = rng.random(d) > 0.2
    mixed = rng.random(d) > 0.5

    t_a = jtable(jnp.asarray(protos), jnp.asarray(coef), spec)
    t_b = jtable(jnp.asarray(protos_b), jnp.asarray(coef), spec)[:, :, ::-1]
    table = jnp.where(jnp.asarray(mixed)[:, None, None], 0.5 * (t_a + t_b),
                      t_a)
    kw = dict(threshold=0.99, floor=0.5, min_pixels=200)
    ref = jfinish(table, jnp.asarray(boxes), jnp.asarray(det_valid), spec,
                  impl="xla", **kw)

    tspec = tpp.LetterboxSpec.build(h0, w0, 640)
    ta = tpp.cropped_prob_table(_t(protos), _t(coef), tspec)
    tb = tpp.cropped_prob_table(_t(protos_b), _t(coef), tspec).flip(-1)
    np.testing.assert_allclose(ta.numpy(), np.asarray(t_a), rtol=0,
                               atol=1e-6)
    # the consensus itself is fed to both tails identically
    params = tpp.PostprocessParams(spec=tspec, mask_threshold=0.99,
                                   mask_threshold_floor=0.5,
                                   mask_min_pixels=200)
    got = tpp._finish_masks(_t(np.asarray(table)), _t(boxes), _t(det_valid),
                            params)
    np.testing.assert_array_equal(got.numpy(), _u32(ref))
    assert (got != 0).any()
    assert tb.shape == ta.shape


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    table, boxes, det_valid = _small_case(rng)
    ops = ma.prepare_operands(_t(table), _t(boxes), _t(det_valid), H, W, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        ma.assemble_masks_cuda(ops)
    with pytest.raises(ValueError, match="CUDA"):
        ma.count_above_cuda(ops)


@pytest.mark.cuda
def test_kernels_match_twins_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    table, boxes, det_valid = _small_case(rng, d=32, mh=42, mw=160)
    ops = ma.prepare_operands(_t(table).to(dev), _t(boxes).to(dev) * 5.5,
                              _t(det_valid).to(dev), 376, 1408, 0.99)
    assert torch.equal(ma.count_above_cuda(ops), ma.count_above_plain(ops))
    assert torch.equal(ma.assemble_masks_cuda(ops),
                       ma.assemble_masks_plain(ops))
