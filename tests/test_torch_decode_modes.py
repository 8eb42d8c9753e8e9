"""The port's decode modes against the JAX package's, on the CPU.

* Mask words bit for bit: logit-space interpolation (cut at
  ``log(t / (1 - t))``), the relative cut (threshold x each detection's
  in-box peak, the port's peak pass), and the detection-only decode (zero
  words), against ``_assemble_masks`` on its XLA path and, for logit, its
  Pallas kernel in interpret mode, and against ``postprocess_single`` on
  the committed n checkpoint's raw outputs.  The port interpolates with
  two taps per axis where XLA resizes with dense matrices, so values may
  differ by 1-2 ulp; on these inputs no pixel lies that close to a cut
  (as ``test_torch_mask_assembly.py`` states).
* ``mask_prob_fields`` and the emitted coefficients within 1e-6;
  ``pack_thresholded_masks`` on the same fields bit for bit.
* ``fast_masks=True``: the port stays exact, so it equals JAX's Pallas
  path bit for bit; against JAX's bf16 XLA path a word may differ only at
  pixels whose float32 probability lies within bf16 epsilon (2^-7) of the
  cut.
* Every invalid combination of the decode's parameters raises where the
  JAX package raises, with its message; so does hflip TTA with a logit or
  relative decode (``validate_tta_params``).
* The detection-only network at n scale on a crop of the committed frame,
  the checkpoint's detection half carried across: boxes within 1e-3 px
  (as ``test_torch_slice.py`` holds the segment network on these crops;
  measured 1.4e-4 px, the float32 network summing in another order) and
  scores within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.models.yolo import postprocess as jpp
from lidar_object_detection_tpu.models.yolo import tta as jtta
from lidar_object_detection_tpu.models.yolo.detector import (
    YoloDetector as JDetector)
from lidar_object_detection_tpu.models.yolo.model import (
    YoloConfig as JConfig)
from lidar_object_detection_tpu_torch.models.yolo import postprocess as tpp
from lidar_object_detection_tpu_torch.models.yolo import tta as ttta
from lidar_object_detection_tpu_torch.models.yolo.detector import (
    YoloDetector)
from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack)
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

CKPT = "checkpoints/yolo11n_seg_distill.msgpack"
H, W = 64, 256          # the synthetic frame: Pallas tiles (8, 128)
H0, W0 = 96, 320        # crops of the committed frame, served at imgsz 160
BF16_EPS = 2.0 ** -7


def _u32(words):
    return np.asarray(words).astype(np.uint32).view(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def synthetic():
    """Smooth protos (16, 64, 32) for a 64 x 256 frame letterboxed at 256
    (no padding), 8 detections' coefficients, boxes and validity."""
    rng = np.random.default_rng(7)
    yy = np.arange(16)[:, None, None] / 16
    xx = np.arange(64)[None, :, None] / 64
    fy, fx, ph = (rng.uniform(0.5, 4, 32), rng.uniform(0.5, 6, 32),
                  rng.uniform(0, 6, 32))
    protos = np.sin(fy * 6 * yy + ph) * np.cos(fx * 4 * xx + ph)
    coef = rng.normal(0, 1.2, (8, 32))
    x1 = rng.uniform(0, W - 60, 8)
    y1 = rng.uniform(0, H - 20, 8)
    boxes = np.stack([x1, y1, x1 + rng.uniform(20, 180, 8),
                      y1 + rng.uniform(10, 44, 8)], 1)
    valid = rng.random(8) > 0.2
    valid[:2] = True
    return (protos.astype(np.float32), coef.astype(np.float32),
            boxes.astype(np.float32), valid)


def _port_words(inputs, **kw):
    protos, coef, boxes, valid = inputs
    params = tpp.PostprocessParams(spec=tpp.LetterboxSpec.build(H, W, W),
                                   **kw)
    table = tpp.cropped_table(_t(protos)[None], _t(coef)[None], params)
    return tpp._finish_masks(table, _t(boxes)[None], _t(valid)[None],
                             params)[0].numpy()


def _jax_words(inputs, impl="xla", **kw):
    protos, coef, boxes, valid = inputs
    return _u32(jpp._assemble_masks(
        jnp.asarray(protos), jnp.asarray(coef), jnp.asarray(boxes),
        jnp.asarray(valid), jpp.LetterboxSpec.build(H, W, W), impl=impl,
        **kw))


@pytest.mark.parametrize("mode,threshold,impl", [
    ("logit", 0.9, "xla"), ("logit", 0.9, "pallas"), ("logit", 0.3, "xla"),
    ("relative", 0.5, "xla"), ("relative", 0.8, "xla")])
def test_mask_words_equal_jax_assembly(synthetic, mode, threshold, impl):
    if mode == "logit":
        kw = dict(upsample="logit")
        tkw = dict(mask_upsample="logit")
    else:
        kw = dict(threshold_mode="relative")
        tkw = dict(mask_threshold_mode="relative")
    ref = _jax_words(synthetic, impl=impl, threshold=threshold, **kw)
    got = _port_words(synthetic, mask_threshold=threshold, **tkw)
    np.testing.assert_array_equal(got, ref)
    assert (ref != 0).sum() > 500
    # the mode changes the words: neither equals the plain absolute cut
    plain = _port_words(synthetic, mask_threshold=threshold)
    assert (got != plain).any()


def test_logit_cut_is_rounded_to_float32():
    params = tpp.PostprocessParams(spec=tpp.LetterboxSpec.build(H, W, W),
                                   mask_threshold=0.9, mask_upsample="logit")
    assert params.table_cut == np.log(0.9 / 0.1)
    table = torch.full((1, 1, 4, 4), float(np.float32(params.table_cut)))
    boxes = torch.tensor([[[0.0, 0.0, 8.0, 8.0]]])
    words = tpp._finish_masks(table, boxes, torch.ones(1, 1, dtype=bool),
                              dataclasses.replace(
                                  params, spec=tpp.LetterboxSpec.build(
                                      8, 8, 8)))
    # the field equals the float32 cut everywhere: v > cut is False
    assert not words.any()


def test_peak_twin_takes_the_in_box_maximum(synthetic):
    from lidar_object_detection_tpu_torch.ops import mask_assembly as ma

    protos, coef, boxes, valid = synthetic
    spec = tpp.LetterboxSpec.build(H, W, W)
    table = tpp.cropped_prob_table(_t(protos)[None], _t(coef)[None], spec)
    peak = ma.peak_batch(table, _t(boxes)[None], _t(valid)[None], H, W)[0]
    fields = tpp.mask_prob_fields(_t(protos), _t(coef), spec)
    ys = torch.arange(H, dtype=torch.float32)[:, None]
    xs = torch.arange(W, dtype=torch.float32)[None, :]
    x1, y1, x2, y2 = (e[:, None, None] for e in _t(boxes).unbind(-1))
    in_box = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    dense = torch.where(in_box, fields, 0.0).amax(dim=(1, 2))
    v = _t(valid)
    np.testing.assert_allclose(peak[v].numpy(), dense[v].numpy(), rtol=0,
                               atol=1e-6)
    assert (peak[~v] == 0).all() and (peak[v] > 0.5).all()


# ---------------------------------------------------------------------------
# the committed n checkpoint's raw outputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw():
    """The port's float32 n forward on two 96 x 320 crops at imgsz 160:
    numpy raw outputs, fed to both packages' decoders."""
    frame = read_png_rgb(chip_smoke.FRAMES[0])
    images = np.ascontiguousarray(np.stack(
        [frame[180:276, 528:848], frame[180:276, 352:672]]))
    variables = read_flax_msgpack(CKPT)["variables"]
    det = YoloDetector((H0, W0), YoloConfig(scale="n"), variables=variables,
                       imgsz=160, device="cpu")
    out = det.forward(images)
    return {k: [x.numpy() for x in v] if isinstance(v, list) else v.numpy()
            for k, v in out.items()}


def _frame(raw, b, wrap):
    return {k: [wrap(x[b]) for x in v] if isinstance(v, list) else wrap(v[b])
            for k, v in raw.items()}


@pytest.mark.parametrize("kw", [
    dict(mask_upsample="logit", mask_threshold=0.9),
    dict(mask_threshold_mode="relative", mask_threshold=0.5),
    dict(mask_threshold=0.5, emit_coef=True),
], ids=["logit", "relative", "emit_coef"])
def test_postprocess_single_equals_jax(raw, kw):
    spec = tpp.LetterboxSpec.build(H0, W0, 160)
    jparams = jpp.PostprocessParams(spec=jpp.LetterboxSpec.build(H0, W0,
                                                                 160), **kw)
    tparams = tpp.PostprocessParams(spec=spec, **kw)
    batched = {k: [_t(x) for x in v] if isinstance(v, list) else _t(v)
               for k, v in raw.items()}
    got = tpp.postprocess_batch(batched, tparams)
    total = 0
    for b in range(2):
        ref = jpp.postprocess_single(_frame(raw, b, jnp.asarray), jparams)
        np.testing.assert_array_equal(got["det_valid"][b].numpy(),
                                      np.asarray(ref["det_valid"]))
        np.testing.assert_allclose(got["boxes"][b].numpy(),
                                   np.asarray(ref["boxes"]), rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(got["mask_bits"][b].numpy(),
                                      _u32(ref["mask_bits"]))
        total += int((np.asarray(ref["mask_bits"]) != 0).sum())
        assert ("coef" in got) == ("coef" in ref)
        if "coef" in ref:
            np.testing.assert_allclose(got["coef"][b].numpy(),
                                       np.asarray(ref["coef"]), rtol=0,
                                       atol=1e-6)
    assert total > 100, "degenerate: no mask pixels"


def test_detection_only_outputs_give_zero_words(raw):
    det_only = {k: raw[k] for k in ("box", "cls")}
    spec = tpp.LetterboxSpec.build(H0, W0, 160)
    got = tpp.postprocess_batch(
        {k: [_t(x) for x in v] for k, v in det_only.items()},
        tpp.PostprocessParams(spec=spec, emit_coef=True))
    jparams = jpp.PostprocessParams(spec=jpp.LetterboxSpec.build(H0, W0, 160),
                                    emit_coef=True)
    for b in range(2):
        ref = jpp.postprocess_single(_frame(det_only, b, jnp.asarray),
                                     jparams)
        assert "coef" not in ref and "coef" not in got
        np.testing.assert_array_equal(got["mask_bits"][b].numpy(),
                                      _u32(ref["mask_bits"]))
        np.testing.assert_array_equal(got["det_valid"][b].numpy(),
                                      np.asarray(ref["det_valid"]))
        np.testing.assert_allclose(got["boxes"][b].numpy(),
                                   np.asarray(ref["boxes"]), rtol=0,
                                   atol=1e-3)
    assert got["det_valid"].sum() >= 2
    assert got["mask_bits"].shape == (2, H0, W0)
    assert not got["mask_bits"].any()


@pytest.mark.parametrize("floor", [None, 0.5])
def test_prob_fields_and_pack_equal_jax(raw, floor):
    spec_t = tpp.LetterboxSpec.build(H0, W0, 160)
    spec_j = jpp.LetterboxSpec.build(H0, W0, 160)
    det = tpp.postprocess_batch(
        {k: [_t(x) for x in v] if isinstance(v, list) else _t(v)
         for k, v in raw.items()},
        tpp.PostprocessParams(spec=spec_t, emit_coef=True))
    coef = det["coef"][0].numpy()
    ref = np.asarray(jpp.mask_prob_fields(jnp.asarray(raw["proto"][0]),
                                          jnp.asarray(coef), spec_j))
    got = tpp.mask_prob_fields(_t(raw["proto"][0]), _t(coef), spec_t)
    assert got.shape == ref.shape == (32, H0, W0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    boxes, valid = det["boxes"][0].numpy(), det["det_valid"][0].numpy()
    kw = dict(floor=floor, min_pixels=400 if floor is not None else 0)
    ref_words = jpp.pack_thresholded_masks(
        jnp.asarray(ref), jnp.asarray(boxes), jnp.asarray(valid), 0.99, **kw)
    words = tpp.pack_thresholded_masks(_t(ref), _t(boxes), _t(valid), 0.99,
                                       **kw)
    np.testing.assert_array_equal(words.numpy(), _u32(ref_words))
    assert (words != 0).any()


def test_fast_masks_exact_equal_pallas_near_bf16_xla(synthetic):
    protos, coef, boxes, valid = synthetic
    got = _port_words(synthetic, mask_threshold=0.5, fast_masks=True)
    exact = _port_words(synthetic, mask_threshold=0.5)
    np.testing.assert_array_equal(got, exact)
    pallas = _jax_words(synthetic, impl="pallas", threshold=0.5, fast=True)
    np.testing.assert_array_equal(got, pallas)
    bf16 = _jax_words(synthetic, impl="xla", threshold=0.5, fast=True)
    diff = (got ^ bf16).view(np.uint32)
    fields = tpp.mask_prob_fields(
        _t(protos), _t(coef), tpp.LetterboxSpec.build(H, W, W)).numpy()
    for d in range(len(valid)):
        flipped = ((diff >> np.uint32(d)) & 1).astype(bool)
        if flipped.any():
            near = np.abs(fields[d][flipped] - 0.5)
            assert near.max() <= BF16_EPS, (d, near.max())


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

INVALID = {
    "upsample": dict(mask_upsample="nearest"),
    "mode": dict(mask_threshold_mode="peak"),
    "relative_logit": dict(mask_threshold_mode="relative",
                           mask_upsample="logit"),
    "floor_above": dict(mask_threshold_floor=0.6, mask_min_pixels=10),
    "floor_equal": dict(mask_threshold_floor=0.5, mask_min_pixels=10),
    "floor_logit": dict(mask_threshold=0.9, mask_threshold_floor=0.5,
                        mask_min_pixels=10, mask_upsample="logit"),
    "floor_relative": dict(mask_threshold=0.9, mask_threshold_floor=0.5,
                           mask_min_pixels=10,
                           mask_threshold_mode="relative"),
    "floor_no_pixels": dict(mask_threshold=0.9, mask_threshold_floor=0.5),
    "logit_one": dict(mask_threshold=1.0, mask_upsample="logit"),
    "logit_zero": dict(mask_threshold=0.0, mask_upsample="logit"),
}
# PostprocessParams field -> _assemble_masks argument
J_ARGS = {"mask_threshold": "threshold", "mask_upsample": "upsample",
          "mask_threshold_mode": "threshold_mode",
          "mask_threshold_floor": "floor", "mask_min_pixels": "min_pixels"}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_invalid_modes_raise_as_jax(synthetic, name):
    kw = INVALID[name]
    protos, coef, boxes, valid = synthetic
    with pytest.raises(ValueError) as ref:
        jpp._assemble_masks(jnp.asarray(protos), jnp.asarray(coef),
                            jnp.asarray(boxes), jnp.asarray(valid),
                            jpp.LetterboxSpec.build(H, W, W),
                            **{J_ARGS[k]: v for k, v in kw.items()})
    with pytest.raises(ValueError) as got:
        tpp.PostprocessParams(spec=tpp.LetterboxSpec.build(H, W, W), **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    dict(mask_upsample="logit", mask_threshold=0.9),
    dict(mask_threshold_mode="relative")], ids=["logit", "relative"])
def test_tta_rejects_logit_and_relative(kw):
    jparams = jpp.PostprocessParams(spec=jpp.LetterboxSpec.build(H, W, W),
                                    **kw)
    with pytest.raises(ValueError) as ref:
        jtta.validate_tta_params(jparams)
    with pytest.raises(ValueError) as got:
        ttta.validate_tta_params(tpp.PostprocessParams(
            spec=tpp.LetterboxSpec.build(H, W, W), **kw))
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as det:
        YoloDetector((H, W), YoloConfig(scale="n"), tta="hflip",
                     device="cpu", **kw)
    assert str(det.value) == str(ref.value)
    # the absolute prob decode is accepted
    ttta.validate_tta_params(tpp.PostprocessParams(
        spec=tpp.LetterboxSpec.build(H, W, W)))


def test_tta_needs_a_segmentation_head(raw):
    det_only = {k: [_t(np.concatenate([x, x])) for x in raw[k]]
                for k in ("box", "cls")}
    params = tpp.PostprocessParams(spec=tpp.LetterboxSpec.build(H0, W0, 160))
    with pytest.raises(ValueError, match="segmentation head"):
        ttta.postprocess_tta(det_only, params)


# ---------------------------------------------------------------------------
# the detection-only network
# ---------------------------------------------------------------------------

def detect_variables(variables):
    """The detection half of a segment=True Flax tree, as the tree of a
    segment=False network: ``head/detect/*`` moves up to ``head/*``, and
    the mask branch (cv4, proto) goes."""
    out = {}
    for collection, tree in variables.items():
        tree = dict(tree)
        tree["head"] = dict(tree["head"]["detect"])
        out[collection] = tree
    return out


def test_detection_head_matches_jax():
    frame = read_png_rgb(chip_smoke.FRAMES[0])
    images = np.ascontiguousarray(frame[None, 180:276, 528:848])
    variables = detect_variables(read_flax_msgpack(CKPT)["variables"])
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jdet = JDetector((H0, W0), JConfig(scale="n", segment=False),
                     variables=jvars, imgsz=160)
    ref = {k: np.asarray(v) for k, v in jdet.detect(images).items()}
    tdet = YoloDetector((H0, W0), YoloConfig(scale="n", segment=False),
                        variables=variables, imgsz=160, device="cpu")
    assert "cv4" not in dict(tdet.model.model["23"].named_children())
    out = tdet.forward(images)
    assert sorted(out) == ["box", "cls"]
    got = {k: v.numpy() for k, v in tdet.decode(out).items()}
    np.testing.assert_array_equal(got["det_valid"], ref["det_valid"])
    v = ref["det_valid"]
    assert v.sum() >= 2, "degenerate: too few cars"
    np.testing.assert_allclose(got["boxes"][v], ref["boxes"][v], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0,
                               atol=1e-5)
    assert not got["mask_bits"].any() and not ref["mask_bits"].any()
