"""Stack-free mask assembly (kernels K2/K3 of the port) against the JAX
package: the Pallas kernels in interpret mode and the XLA resize path.

The plain twins interpolate with the same two taps per axis as the Pallas
kernels (``resize_taps``, pinned equal to JAX's here), y first then x,
each product and sum rounded on its own.  The XLA path resizes with dense
weight matrices instead, so the values may differ by 1-2 ulp and a pixel
within that distance of its cut could flip; the tests still require equal
words, as the JAX package's own Pallas tests do against XLA, because on
these inputs no pixel lies that close to a cut.

The twins and kernels take a batch of frames (B, D, mh, mw); the JAX
functions take one frame, so the batch is compared frame by frame.  The
JAX package is imported only inside the tests that compare with it, so
that the card tests here collect on a card's machine without it:

    python -m pytest tests/test_torch_mask_assembly.py -m cuda

On the card, kernel and twin agree bit for bit (tolerance: none).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu_torch.models.yolo import postprocess as tpp
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops import mask_assembly as ma
from lidar_object_detection_tpu_torch.ops.resize import resize_taps

H, W = 64, 256


def _jax():
    """jax.numpy, the JAX package's postprocess module and its Pallas mask
    kernels."""
    import jax.numpy as jnp
    from lidar_object_detection_tpu.models.yolo import postprocess as jpp
    from lidar_object_detection_tpu.ops import pallas_masks as pm
    return jnp, jpp, pm


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
    _, _, pm = _jax()
    ref = pm.resize_taps(n_in, n_out)
    got = resize_taps(n_in, n_out)
    for a, b in zip(ref[:3], got):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("threshold", [0.5, 0.99])
def test_twins_match_pallas_kernels(rng, threshold):
    jnp, _, pm = _jax()
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
    jnp, jpp, pm = _jax()
    table, boxes, det_valid = _small_case(rng)
    kw = dict(threshold=0.99, floor=0.5, min_pixels=200)
    ref_pallas = pm.pallas_assemble_masks_guarded(
        jnp.asarray(table), jnp.asarray(boxes), jnp.asarray(det_valid), H, W,
        interpret=True, **kw)
    spec = jpp.LetterboxSpec.build(H, W, 640)
    ref_xla = jpp._finish_masks(jnp.asarray(table), jnp.asarray(boxes),
                                jnp.asarray(det_valid), spec, impl="xla",
                                **kw)
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
    jnp, jpp, _ = _jax()
    table, boxes, det_valid = _small_case(rng, d=6)
    spec_j = jpp.LetterboxSpec.build(H, W, 640)
    kw = dict(threshold=threshold, floor=floor,
              min_pixels=200 if floor is not None else 0)
    ref = jpp._finish_masks(jnp.asarray(table), jnp.asarray(boxes),
                            jnp.asarray(det_valid), spec_j, impl="xla", **kw)
    params = tpp.PostprocessParams(
        spec=tpp.LetterboxSpec.build(H, W, 640), mask_threshold=threshold,
        mask_threshold_floor=floor, mask_min_pixels=kw["min_pixels"])
    got = tpp._finish_masks(_t(table)[None], _t(boxes)[None],
                            _t(det_valid)[None], params)[0]
    np.testing.assert_array_equal(got.numpy(), _u32(ref))


def test_twin_serves_tta_consensus_table(rng):
    """Mirror of the JAX package's ``test_kernel_serves_tta_consensus_table``
    at the full 376 x 1408 frame: an averaged, width-mirrored proto-res
    table at the guarded serving point, against the XLA tail."""
    jnp, jpp, _ = _jax()
    h0, w0 = 376, 1408
    spec = jpp.LetterboxSpec.build(h0, w0, 640)
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

    t_a = jpp.cropped_prob_table(jnp.asarray(protos), jnp.asarray(coef),
                                 spec)
    t_b = jpp.cropped_prob_table(jnp.asarray(protos_b), jnp.asarray(coef),
                                 spec)[:, :, ::-1]
    table = jnp.where(jnp.asarray(mixed)[:, None, None], 0.5 * (t_a + t_b),
                      t_a)
    kw = dict(threshold=0.99, floor=0.5, min_pixels=200)
    ref = jpp._finish_masks(table, jnp.asarray(boxes),
                            jnp.asarray(det_valid), spec, impl="xla", **kw)

    tspec = tpp.LetterboxSpec.build(h0, w0, 640)
    ta = tpp.cropped_prob_table(_t(protos), _t(coef), tspec)
    tb = tpp.cropped_prob_table(_t(protos_b), _t(coef), tspec).flip(-1)
    np.testing.assert_allclose(ta.numpy(), np.asarray(t_a), rtol=0,
                               atol=1e-6)
    # the consensus itself is fed to both tails identically
    params = tpp.PostprocessParams(spec=tspec, mask_threshold=0.99,
                                   mask_threshold_floor=0.5,
                                   mask_min_pixels=200)
    got = tpp._finish_masks(_t(np.asarray(table))[None], _t(boxes)[None],
                            _t(det_valid)[None], params)[0]
    np.testing.assert_array_equal(got.numpy(), _u32(ref))
    assert (got != 0).any()
    assert tb.shape == ta.shape


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    table, boxes, det_valid = _small_case(rng)
    ops = ma.prepare_operands(_t(table)[None], _t(boxes)[None],
                              _t(det_valid)[None], H, W, 0.5)
    before = dict(kernel_lib.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ma.assemble_masks_cuda(ops)
    with pytest.raises(ValueError, match="CUDA"):
        ma.count_above_cuda(ops)
    assert kernel_lib.LAUNCHES == before


def _batch_of_three(rng, d=8):
    """Three frames with 0, 1 and all 8 of 8 detections valid."""
    frames = [_small_case(rng, d=d) for _ in range(3)]
    table, boxes, valid = (np.stack(a) for a in zip(*frames))
    valid[0] = False
    valid[1] = np.arange(d) == 3
    valid[2] = True
    return table, boxes, valid


def test_batched_twins_match_pallas_frame_by_frame(rng):
    """One batched call of each twin equals the Pallas kernels run frame by
    frame in interpret mode: counts, plain words and guarded words."""
    jnp, _, pm = _jax()
    table, boxes, valid = _batch_of_three(rng)
    targs = (_t(table), _t(boxes), _t(valid), H, W)
    counts = ma.count_above_batch(*targs, 0.99)
    words = ma.assemble_masks_batch(*targs, 0.5)
    guarded = ma.assemble_masks_guarded_batch(*targs, 0.99, 0.5, 200)
    assert counts.shape == (3, 8) and words.shape == (3, H, W)
    fired = 0
    for b in range(3):
        jargs = (jnp.asarray(table[b]), jnp.asarray(boxes[b]),
                 jnp.asarray(valid[b]), H, W)
        ref_counts = pm.pallas_count_above(*jargs, threshold=0.99,
                                           interpret=True)
        ref_words = pm.pallas_assemble_masks(*jargs, threshold=0.5,
                                             interpret=True)
        ref_guarded = pm.pallas_assemble_masks_guarded(
            *jargs, threshold=0.99, floor=0.5, min_pixels=200,
            interpret=True)
        np.testing.assert_array_equal(counts[b].numpy(),
                                      np.asarray(ref_counts))
        np.testing.assert_array_equal(words[b].numpy(), _u32(ref_words))
        np.testing.assert_array_equal(guarded[b].numpy(),
                                      _u32(ref_guarded))
        fired += int(((np.asarray(ref_counts) < 200) & valid[b]).sum())
    assert not bool(words[0].any()) and not bool(counts[0].any())
    assert bool(words[1].any()) and bool(words[2].any())
    assert 0 < fired < int(valid.sum()), "the guard must fire for some"


def test_device_cut_rule_matches_guarded_thresholds_and_jax(rng):
    """K2's cut rule (``Guard``: counts against ``min_pixels``, ``>=``
    keeps the primary cut) equals ``guarded_thresholds`` and the JAX
    package's composition, with counts exactly at ``min_pixels``; the
    words it cuts equal ``pallas_assemble_masks`` at JAX's cuts."""
    jnp, _, pm = _jax()
    table, boxes, valid = _batch_of_three(rng)
    ops = ma.prepare_operands(_t(table), _t(boxes), _t(valid), H, W, 0.99)
    counts = ma.count_above_plain(ops)
    at = int(counts[2].max())
    assert at > 0
    for min_pixels in (at, at + 1, 200):
        guard = ma.Guard(counts, 0.5, min_pixels)
        cut = ma.guarded_cut(ops.thr, guard)
        ref = np.asarray(jnp.where(jnp.asarray(counts.numpy()) >= min_pixels,
                                   jnp.float32(0.99), jnp.float32(0.5)))
        np.testing.assert_array_equal(cut.numpy(), ref)
        np.testing.assert_array_equal(
            cut.numpy(),
            ma.guarded_thresholds(counts, 0.99, 0.5, min_pixels).numpy())
        words = ma.assemble_masks_plain(ops, guard)
        for b in range(3):
            ref_words = pm.pallas_assemble_masks(
                jnp.asarray(table[b]), jnp.asarray(boxes[b]),
                jnp.asarray(valid[b]), H, W, threshold=jnp.asarray(ref[b]),
                interpret=True)
            np.testing.assert_array_equal(words[b].numpy(),
                                          _u32(ref_words))
    # the detection whose count equals min_pixels keeps the primary cut
    top = int(counts[2].argmax())
    assert float(ma.guarded_cut(ops.thr, ma.Guard(counts, 0.5, at))[2, top]) \
        == np.float32(0.99)
    assert float(ma.guarded_cut(ops.thr, ma.Guard(counts, 0.5, at + 1))[
        2, top]) == np.float32(0.5)


@pytest.mark.parametrize("name", ["no valid detection", "D=1",
                                  "off the image", "borders and fractions"])
def test_twins_match_pallas_on_edge_cases(name):
    """The smoke's K2/K3 edge cases at 64 x 256: the batched twins equal
    the Pallas kernels frame by frame."""
    jnp, _, pm = _jax()
    table, boxes, valid = chip_smoke.mask_cases(
        np.random.default_rng(7), h=H, w=W, mh=12, mw=40)[name]
    targs = (_t(table), _t(boxes), _t(valid), H, W)
    counts = ma.count_above_batch(*targs, 0.5)
    guarded = ma.assemble_masks_guarded_batch(*targs, 0.5, 0.2, 40)
    for b in range(len(table)):
        jargs = (jnp.asarray(table[b]), jnp.asarray(boxes[b]),
                 jnp.asarray(valid[b]), H, W)
        np.testing.assert_array_equal(
            counts[b].numpy(), np.asarray(pm.pallas_count_above(
                *jargs, threshold=0.5, interpret=True)))
        np.testing.assert_array_equal(
            guarded[b].numpy(), _u32(pm.pallas_assemble_masks_guarded(
                *jargs, threshold=0.5, floor=0.2, min_pixels=40,
                interpret=True)))
    assert bool(counts.any())


def test_single_frame_functions_are_batch_of_one(rng):
    table, boxes, valid = _batch_of_three(rng)
    args = [(_t(table[b]), _t(boxes[b]), _t(valid[b]), H, W)
            for b in range(3)]
    batch = (_t(table), _t(boxes), _t(valid), H, W)
    thr = torch.linspace(0.3, 0.9, 8)
    words = ma.assemble_masks_batch(*batch, thr.expand(3, 8))
    counts = ma.count_above_batch(*batch, 0.5)
    guarded = ma.assemble_masks_guarded_batch(*batch, 0.99, 0.5, 200)
    for b in range(3):
        assert torch.equal(ma.assemble_masks(*args[b], thr), words[b])
        assert torch.equal(ma.count_above(*args[b], 0.5), counts[b])
        assert torch.equal(ma.assemble_masks_guarded(*args[b], 0.99, 0.5,
                                                     200), guarded[b])


def test_twins_build_one_frame_stack_at_a_time(rng, monkeypatch):
    """The twins hold one frame's (D, H, W) stack at a time, so their peak
    memory does not grow with the batch; an empty batch gives empty
    outputs."""
    table, boxes, valid = _batch_of_three(rng)
    ops = ma.prepare_operands(_t(table), _t(boxes), _t(valid), H, W, 0.5)
    shapes = []
    inner = ma._binary_plain

    def spy(ops, cut, b):
        out = inner(ops, cut, b)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(ma, "_binary_plain", spy)
    ma.count_above_plain(ops)
    ma.assemble_masks_plain(ops)
    assert shapes == [(8, H, W)] * 6
    empty = ma.prepare_operands(_t(table[:0]), _t(boxes[:0]), _t(valid[:0]),
                                H, W, 0.5)
    assert ma.count_above_plain(empty).shape == (0, 8)
    assert ma.assemble_masks_plain(empty).shape == (0, H, W)


def test_mask_bound_counts_only_the_table_entries_boxes_reach(rng):
    """The smoke's K2/K3 bound reads, per valid box with pixels, only the
    table entries its pixels' taps touch (found here by walking the
    pixels), plus the taps of the covered rows and columns, the slots and
    the counts; K2 adds the words.  Operations: 3 per (row, table column)
    and 4 per (pixel, detection) pair."""
    table, boxes, valid = _batch_of_three(rng)
    boxes[1, 0] = [-30, -5, 3.5, 2.2]            # clipped at the corner
    boxes[1, 1] = [10, 10, 10, 30]               # empty
    ops = ma.prepare_operands(_t(table), _t(boxes), _t(valid), H, W, 0.5)
    y0, x0 = ops.y0.numpy(), ops.x0.numpy()
    mh, mw = table.shape[-2:]
    n_bytes, n_ops = 0, 0
    rows_used, cols_used = set(), set()
    for b, d in zip(*np.nonzero(valid)):
        x1, y1, x2, y2 = boxes[b, d]
        ys = [y for y in range(H) if y1 <= y < y2]
        xs = [x for x in range(W) if x1 <= x < x2]
        if not ys or not xs:
            continue
        t_rows = {r for y in ys for r in (y0[y], min(y0[y] + 1, mh - 1))}
        t_cols = {c for x in xs for c in (x0[x], min(x0[x] + 1, mw - 1))}
        n_bytes += 4 * len(t_rows) * len(t_cols)
        n_ops += 3 * len(ys) * len(t_cols) + 4 * len(ys) * len(xs)
        rows_used.update(ys)
        cols_used.update(xs)
    n_bytes += 12 * (len(rows_used) + len(cols_used)) + 3 * 8 * (21 + 4)
    full = 4 * mh * mw * int(valid.sum())
    assert n_bytes < full
    assert chip_smoke.mask_bound(ops, True) == \
        chip_smoke.bound_ms(n_bytes, n_ops)
    assert chip_smoke.mask_bound(ops, False) == \
        chip_smoke.bound_ms(n_bytes + 4 * 3 * H * W, n_ops)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_twins_on_card(rng):
    dev = _card()
    table, boxes, det_valid = _small_case(rng, d=32, mh=42, mw=160)
    ops = ma.prepare_operands(_t(table)[None].to(dev),
                              _t(boxes)[None].to(dev) * 5.5,
                              _t(det_valid)[None].to(dev), 376, 1408, 0.99)
    assert torch.equal(ma.count_above_cuda(ops), ma.count_above_plain(ops))
    assert torch.equal(ma.assemble_masks_cuda(ops),
                       ma.assemble_masks_plain(ops))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense B=4", "dense B=1",
                                  "no valid detection", "D=1",
                                  "off the image", "borders and fractions"])
def test_batched_kernels_equal_twins_on_edge_cases(name):
    """One launch of K3 and of K2 (plain cut, guard that fires for some
    detections, guard with a count exactly at ``min_pixels``) equals the
    twins on the smoke's edge cases at 376 x 1408."""
    dev = _card()
    table, boxes, valid = (torch.from_numpy(a).to(dev) for a in
                           chip_smoke.mask_cases(np.random.default_rng(3))[
                               name])
    ops = ma.prepare_operands(table, boxes, valid, 376, 1408, 0.99)
    before = dict(kernel_lib.LAUNCHES)
    counts = ma.count_above_cuda(ops)
    assert torch.equal(counts, ma.count_above_plain(ops))
    assert torch.equal(ma.assemble_masks_cuda(ops),
                       ma.assemble_masks_plain(ops))
    nonzero = counts[counts > 0]
    at = int(nonzero.min()) if nonzero.numel() else 1
    for min_pixels in (200, at):
        guard = ma.Guard(counts, 0.5, min_pixels)
        assert torch.equal(ma.assemble_masks_cuda(ops, guard),
                           ma.assemble_masks_plain(ops, guard))
    assert kernel_lib.LAUNCHES["mask_count"] == before["mask_count"] + 1
    assert kernel_lib.LAUNCHES["mask_assemble"] == \
        before["mask_assemble"] + 3
    if name == "no valid detection":
        assert not bool(counts[0].any())


@pytest.mark.cuda
def test_batch_launch_equals_launch_per_frame():
    dev = _card()
    table, boxes, valid = (torch.from_numpy(a).to(dev) for a in
                           chip_smoke.mask_cases(np.random.default_rng(4))[
                               "dense B=4"])
    ops = ma.prepare_operands(table, boxes, valid, 376, 1408, 0.99)
    counts = ma.count_above_cuda(ops)
    words = ma.assemble_masks_cuda(ops, ma.Guard(counts, 0.5, 200))
    for b in range(4):
        one = ma.prepare_operands(table[b:b + 1], boxes[b:b + 1],
                                  valid[b:b + 1], 376, 1408, 0.99)
        c = ma.count_above_cuda(one)
        assert torch.equal(c[0], counts[b])
        assert torch.equal(ma.assemble_masks_cuda(
            one, ma.Guard(c, 0.5, 200))[0], words[b])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [W - 1, W - 2, W - 3])
def test_kernels_serve_width_not_multiple_of_4(rng, width):
    """K3, K2 (plain cut and guarded) and the peak pass at a width of 1, 2
    and 3 mod 4 equal the twins, one launch each."""
    dev = _card()
    table, boxes, valid = _small_case(rng)
    boxes[:3] = [[width - 3, 0, width, H], [width - 1.5, 5, width + 9, 40],
                 [0, 0, width + 100, H + 1]]
    ops = ma.prepare_operands(_t(table)[None].to(dev), _t(boxes)[None].to(dev),
                              _t(valid)[None].to(dev), H, width, 0.5)
    before = dict(kernel_lib.LAUNCHES)
    counts = ma.count_above_cuda(ops)
    assert torch.equal(counts, ma.count_above_plain(ops))
    assert torch.equal(ma.assemble_masks_cuda(ops),
                       ma.assemble_masks_plain(ops))
    guard = ma.Guard(counts, 0.2, 40)
    assert torch.equal(ma.assemble_masks_cuda(ops, guard),
                       ma.assemble_masks_plain(ops, guard))
    assert torch.equal(ma.peak_cuda(ops).view(torch.int32),
                       ma.peak_plain(ops).view(torch.int32))
    assert int(counts.sum()) > 0
    assert kernel_lib.LAUNCHES["mask_count"] == before["mask_count"] + 1
    assert kernel_lib.LAUNCHES["mask_assemble"] == \
        before["mask_assemble"] + 2


@pytest.mark.cuda
def test_wrapper_raises_on_cpu_tensors_and_wrong_shapes(rng):
    dev = _card()
    table, boxes, valid = _small_case(rng)
    cpu = ma.prepare_operands(_t(table)[None], _t(boxes)[None],
                              _t(valid)[None], H, W, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        ma.count_above_cuda(cpu)
    before = dict(kernel_lib.LAUNCHES)
    ops = ma.prepare_operands(_t(table)[None].to(dev), _t(boxes)[None].to(dev),
                              _t(valid)[None].to(dev), H, W, 0.5)
    with pytest.raises(ValueError, match="shape"):
        ma.launch("mask_assemble_launch", ops,
                  torch.empty((1, H, W - 4), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="shape"):
        ma.launch("mask_count_launch", ops,
                  torch.zeros((1, H, W), dtype=torch.int32, device=dev))
    assert kernel_lib.LAUNCHES == before
