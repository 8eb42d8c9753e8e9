"""The port at the x scale, the JAX headline's detector, against the JAX
package on the CPU: the committed ``yolo11x_seg_distill`` checkpoint read,
the YOLO11x-seg forward in float32 and folded bf16, and the single-view
decode at the sidecar's guarded point (0.99 with floor 0.5 at 200 px), as
``bench.py``'s headline serves it (``tta="none"``; JAX with
``fast_masks=False``, since the port's mask kernel works in float32).

The source is two 96 x 320 crops of a real KITTI-360 camera frame, the
first with two cars in it, and the mirror of the first, served at
``imgsz=320``; and, at full size, the mirrors of the two committed frames,
on which the x detector finds no car.  The x scale uses C3k inner blocks
in every C3k2 and two repeats per block, where n uses C3k only at layers
6, 8 and 22.

The reference is the JAX package as it serves: its forward and its
``detect`` under ``jax.jit``.  The x checkpoint stores its arrays in
bfloat16.  A Flax BatchNorm then computes its multiplier ``rsqrt(var +
eps) * gamma`` in bfloat16; compiled, XLA keeps the product in float32,
and op by op it rounds the product too, which the x network amplifies to
a difference of up to 2.4 between JAX's two modes on these crops
(channels whose variance is near zero carry multipliers in the hundreds).
``common.BatchNorm`` evaluates with the rounding of the jitted forward.
Stated tolerances:

* checkpoint arrays: bit-equal to ``flax.serialization.msgpack_restore``;
* the float32 network on the same letterboxed input, against JAX's jitted
  forward: at most 1e-3 on any output (measured 7.7e-5 on outputs up to
  15);
* the decode of the same raw outputs: equal validity, slots and packed mask
  words, boxes within 1e-3 px, scores within 1e-5;
* the port's detector end to end (its own letterbox, forward and decode)
  against JAX's jitted ``detect``: equal validity, boxes within 1e-3 px and
  scores within 1e-5 (measured 6.1e-5 px and 3.3e-6), at most 1e-3 of the
  mask words differing (measured 0); on the full-size mirrored frames
  equal validity, no car in either package;
* folded bf16: over the 256 anchors of highest float32 car score per
  frame, the port's bf16 car logits drift from its float32 ones no more
  than 1.5 times JAX's jitted bf16 from JAX's jitted float32 (the measure
  of ``tests/test_torch_bf16.py``), and the port's float32 logits lie
  within a tenth of that of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from lidar_object_detection_tpu.models.yolo.postprocess import (
    letterbox_image as jletterbox, postprocess_single as jpostprocess)
from lidar_object_detection_tpu.models.yolo.serving import (
    load_serving_checkpoint as jload)
from lidar_object_detection_tpu_torch.models.yolo.model import (
    Yolo11, YoloConfig)
from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
    PostprocessParams, postprocess_batch)
from lidar_object_detection_tpu_torch.models.yolo.serving import (
    load_serving_checkpoint)
from lidar_object_detection_tpu_torch.models.yolo.weights import (
    from_flax_variables)
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack)
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

CKPT = "checkpoints/yolo11x_seg_distill.msgpack"
H0, W0 = 96, 320
TOP = 256
IMGSZ = 320


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _np_tree(out):
    return {k: [np.asarray(x, np.float32) for x in v] if isinstance(v, list)
            else np.asarray(v, np.float32) for k, v in out.items()}


def _crops():
    """Two crops of the first committed frame and the mirror of the
    first."""
    frame = read_png_rgb(chip_smoke.FRAMES[0])
    mirror = frame[:, ::-1]
    w = frame.shape[1]
    return np.ascontiguousarray(np.stack(
        [frame[180:276, 528:848], frame[180:276, 352:672],
         mirror[180:276, w - 848:w - 528]]))


@pytest.fixture(scope="module")
def served():
    """The crops, the JAX float32 detector at the single-view guarded
    point, its letterboxed input, its raw float32 outputs and detections
    under jit, and the JAX folded bf16 network's raw outputs on the bf16
    letterbox under jit."""
    images = _crops()
    jdet, jstep, res = jload(CKPT, (H0, W0), imgsz=IMGSZ, tta="none")
    assert res["tta"] == "none" and res["mask_threshold"] == 0.99
    assert res["mask_threshold_floor"] == 0.5
    assert res["mask_min_pixels"] == 200
    imgs = images.astype(np.float32) / np.float32(255.0)
    lb = np.stack([np.asarray(jletterbox(jnp.asarray(im), jdet.spec))
                   for im in imgs])
    raw = _np_tree(jax.jit(jdet.model.apply)(jdet.variables,
                                             jnp.asarray(lb)))
    detected = {k: np.asarray(v) for k, v in jdet.detect(images).items()}
    jbf = jload(CKPT, (H0, W0), imgsz=IMGSZ, tta="none", fold_weights=True,
                dtype=jnp.bfloat16)[0]
    dt = jbf.model.dtype
    lb16 = jax.vmap(lambda im: jletterbox(im, jbf.spec))(
        jnp.asarray(images).astype(dt) / jnp.asarray(255.0, dt))
    raw16 = _np_tree(jax.jit(jbf.model.apply)(jbf.variables, lb16))
    detected16 = {k: np.asarray(v) for k, v in jbf.detect(images).items()}
    return {"images": images, "jdet": jdet, "step": jstep, "res": res,
            "lb": lb, "raw": raw, "detected": detected, "raw16": raw16,
            "detected16": detected16}


def test_x_reader_bit_equal_to_flax():
    with open(CKPT, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    got = read_flax_msgpack(CKPT)
    ref_leaves = dict(_leaves(ref))
    got_leaves = dict(_leaves(got))
    assert ref_leaves.keys() == got_leaves.keys()
    n_bf16 = 0
    for key, want in ref_leaves.items():
        have = got_leaves[key]
        if isinstance(have, torch.Tensor):
            assert have.dtype == torch.bfloat16, key
            have = have.view(torch.int16).numpy()
            want = np.asarray(want).view(np.int16)
            n_bf16 += 1
        want = np.asarray(want)
        have = np.asarray(have)
        assert have.dtype == want.dtype and have.shape == want.shape, key
        assert have.tobytes() == want.tobytes(), key
    assert n_bf16 > 500
    # x: C3k in every C3k2, two repeats
    sd = from_flax_variables(got["variables"])
    assert "model.2.m.1.m.1.cv2.conv.weight" in sd
    assert "model.16.m.0.m.1.cv1.bn.running_mean" in sd
    assert sd["model.0.conv.weight"].shape == (96, 3, 3, 3)


def test_x_forward_matches_flax(served):
    model = Yolo11(YoloConfig(scale="x"))
    model.load_state_dict(from_flax_variables(
        read_flax_msgpack(CKPT)["variables"]), strict=True)
    with torch.no_grad():
        got = model.float().eval()(torch.from_numpy(served["lb"]))
    ref = served["raw"]
    err = 0.0
    for key in ("box", "cls", "coef", "proto"):
        have = got[key] if key != "proto" else [got[key]]
        want = ref[key] if key != "proto" else [ref[key]]
        assert len(have) == len(want)
        for a, b in zip(want, have):
            assert a.shape == tuple(b.shape), key
            err = max(err, float(np.abs(b.numpy() - a).max()))
    print(f"x float32 forward: port against JAX's jitted forward {err:.2e}")
    assert err <= 1e-3
    assert max(float(np.abs(x).max()) for x in ref["cls"]) > 5


def _jax_decode(raw, jdet):
    """The JAX package's single-view decode of each frame's raw outputs
    (``fast_masks=False``)."""
    assert not jdet.params.fast_masks
    out = []
    for b in range(raw["proto"].shape[0]):
        one = {k: [jnp.asarray(x[b]) for x in v] if isinstance(v, list)
               else jnp.asarray(v[b]) for k, v in raw.items()}
        out.append({k: np.asarray(v)
                    for k, v in jpostprocess(one, jdet.params).items()})
    return {k: np.stack([o[k] for o in out]) for k in out[0]}


def test_x_single_view_guarded_decode_matches_jax(served):
    """The same raw x outputs decoded by both packages' single-view
    decode at the guarded point: validity, slots and mask words equal."""
    raw, jdet, res = served["raw"], served["jdet"], served["res"]
    ref = _jax_decode(raw, jdet)
    params = PostprocessParams(
        spec=load_serving_checkpoint(CKPT, (H0, W0), imgsz=IMGSZ, tta="none",
                                     device="cpu")[0].spec,
        mask_threshold=res["mask_threshold"],
        mask_threshold_floor=res["mask_threshold_floor"],
        mask_min_pixels=res["mask_min_pixels"])
    t = lambda a: torch.from_numpy(np.array(a))
    got = postprocess_batch({k: [t(x) for x in v] if isinstance(v, list)
                             else t(v) for k, v in raw.items()}, params)
    np.testing.assert_array_equal(got["det_valid"].numpy(), ref["det_valid"])
    v = ref["det_valid"]
    assert v[0].sum() >= 2, "degenerate: too few cars"
    np.testing.assert_allclose(got["boxes"].numpy()[v], ref["boxes"][v],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy()[v], ref["scores"][v],
                               rtol=0, atol=1e-5)
    words = ref["mask_bits"].astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got["mask_bits"].numpy(), words)
    assert (words != 0).any()


def _assert_detections_match(got, ref):
    np.testing.assert_array_equal(got["det_valid"], ref["det_valid"])
    v = ref["det_valid"]
    np.testing.assert_allclose(got["boxes"][v], ref["boxes"][v], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"][v], ref["scores"][v], rtol=0,
                               atol=1e-5)
    words = ref["mask_bits"].astype(np.uint32).view(np.int32)
    share = float((got["mask_bits"] != words).mean())
    assert share <= 1e-3, f"mask-word mismatch share {share}"


def test_x_detector_matches_jax(served):
    """The port's single-view x detector on the crops (its own letterbox,
    forward and decode) against JAX's jitted ``detect``."""
    tdet, step, res = load_serving_checkpoint(CKPT, (H0, W0), imgsz=IMGSZ,
                                              tta="none", device="cpu")
    assert step == served["step"] and res == served["res"]
    assert tdet.cfg.scale == "x" and tdet.tta == "none"
    got = {k: v.numpy() for k, v in tdet.detect(served["images"]).items()}
    ref = served["detected"]
    _assert_detections_match(got, ref)
    v = ref["det_valid"]
    assert v[0].sum() >= 2 and v[2].sum() >= 1, "degenerate: too few cars"
    assert (got["mask_bits"] != 0).any()


def test_x_detector_matches_jax_on_mirrored_frames():
    """The full-size mirrors of the committed frames, which the card's
    headline stream serves, through both packages' single-view x
    detector: both find no car, so the zero picks there are the model's."""
    frames = np.ascontiguousarray(np.stack(
        [read_png_rgb(path)[:, ::-1] for path in chip_smoke.FRAMES]))
    shape = frames.shape[1:3]
    jdet = jload(CKPT, shape, tta="none")[0]
    ref = {k: np.asarray(v) for k, v in jdet.detect(frames).items()}
    tdet = load_serving_checkpoint(CKPT, shape, tta="none", device="cpu")[0]
    got = {k: v.numpy() for k, v in tdet.detect(frames).items()}
    _assert_detections_match(got, ref)
    assert not ref["det_valid"].any()


def _iou(a, b):
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], -1)
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def _found(dets, b, boxes, scores, score_tol):
    """Whether each of (boxes, scores) has a detection of ``dets``' frame
    ``b`` at IoU 0.9 or more with a score within ``score_tol``."""
    v = dets["det_valid"][b]
    if not v.any():
        return np.zeros(len(boxes), bool)
    iou = _iou(boxes, dets["boxes"][b][v])
    close = np.abs(scores[:, None] - dets["scores"][b][v][None]) <= score_tol
    return ((iou >= 0.9) & close).any(1)


def test_x_bf16_detector_matches_jax(served):
    """The folded bf16 x detector, as the headline serves it, against
    JAX's jitted folded bf16 ``detect`` on the crops.  bf16 moves scores
    and boxes enough that NMS can keep or drop a car that overlaps another
    (on the first crop JAX's bf16 drops the second car, 0.39 in float32,
    which the port's keeps), so: each of JAX's bf16 detections is one of
    the port's (IoU at least 0.9, score within 0.06; measured 0.045), and
    each of the port's is one of JAX's bf16 or float32 detections."""
    tdet = load_serving_checkpoint(CKPT, (H0, W0), imgsz=IMGSZ, tta="none",
                                   device="cpu", dtype=torch.bfloat16,
                                   fold_weights=True)[0]
    got = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
           for k, v in tdet.detect(served["images"]).items()}
    ref, ref32 = served["detected16"], served["detected"]
    assert ref["det_valid"][0].sum() >= 1, "degenerate: too few cars"
    for b in range(len(served["images"])):
        v, w = ref["det_valid"][b], got["det_valid"][b]
        assert _found(got, b, ref["boxes"][b][v], ref["scores"][b][v],
                      0.06).all(), b
        mine = got["boxes"][b][w], got["scores"][b][w]
        assert (_found(ref, b, *mine, 0.06)
                | _found(ref32, b, *mine, 0.06)).all(), b
    assert (got["mask_bits"] != 0).any()


def _car_logits(cls_levels, n):
    return np.concatenate([np.asarray(x, np.float32).reshape(
        n, -1, x.shape[-1]) for x in cls_levels], 1)[..., 2]


def test_x_bf16_drift_is_within_jax(served):
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        letterbox_image)

    images = served["images"]
    n = len(images)
    bf16 = load_serving_checkpoint(CKPT, (H0, W0), imgsz=IMGSZ, tta="none",
                                   device="cpu", dtype=torch.bfloat16,
                                   fold_weights=True)[0]
    f32 = load_serving_checkpoint(CKPT, (H0, W0), imgsz=IMGSZ, tta="none",
                                  device="cpu")[0]

    def port_logits(det):
        with torch.no_grad():
            lb = letterbox_image(torch.from_numpy(images).float() / 255.0,
                                 det.spec)
            out = det.model(lb.to(det.dtype))
        return _car_logits([x.float().numpy() for x in out["cls"]], n)

    ref = _car_logits(served["raw"]["cls"], n)
    top = np.argsort(-ref, axis=1)[:, :TOP]
    drift = lambda logits: float(np.abs(np.take_along_axis(
        logits - ref, top, 1)).mean())
    jax_drift = drift(_car_logits(served["raw16"]["cls"], n))
    port_drift = drift(port_logits(bf16))
    f32_drift = drift(port_logits(f32))
    print(f"x car-logit drift of bf16 from float32: port {port_drift:.4f}, "
          f"JAX {jax_drift:.4f}; port float32 from JAX's {f32_drift:.4f}")
    assert f32_drift < 0.1 * jax_drift
    assert 0 < port_drift <= 1.5 * jax_drift, (port_drift, jax_drift)


@pytest.mark.parametrize("case", ["x checkpoint", "folded bf16",
                                  "float32"])
def test_batchnorm_rounds_as_flax_under_jit(case):
    """The port's ``BatchNorm`` in evaluation against Flax's ``BatchNorm``
    under ``jax.jit``:

    * the statistics of every BatchNorm channel of the x checkpoint, stored
      in bfloat16, float32 inputs: within 1e-5 of the jitted output (the
      fused multiply-add may round differently), and far from what
      rounding the multiplier to bfloat16 as well, as Flax does op by op,
      gives;
    * a folded bf16 tree (mean 0, variance 1 - eps, scale 1) on bfloat16
      inputs, as the serving path runs: equal bit for bit, to the jitted
      and to the op-by-op output (the multiplier is exactly 1 in both);
    * float32 statistics and inputs: within 2 float32 ulps (``rsqrt`` is
      not correctly rounded in XLA)."""
    from flax import linen as fnn

    from lidar_object_detection_tpu_torch.models.common import BatchNorm

    rng = np.random.default_rng(11)
    c = 512
    stats, x_dtype = {"x checkpoint": ("bfloat16", "float32"),
                      "folded bf16": ("bfloat16", "bfloat16"),
                      "float32": ("float32", "float32")}[case]
    arrays = {"var": rng.uniform(1e-4, 5, c), "mean": rng.normal(0, 1, c),
              "scale": rng.uniform(0.1, 40, c), "bias": rng.normal(0, 1, c)}
    if case == "folded bf16":
        arrays.update(var=np.full(c, 1 - 1e-3), mean=np.zeros(c),
                      scale=np.ones(c))
    if case == "x checkpoint":
        # every BatchNorm channel of the x checkpoint, side by side
        sd = from_flax_variables(read_flax_msgpack(CKPT)["variables"])
        cat = lambda end: np.concatenate([
            v.float().numpy() for k, v in sd.items() if k.endswith(end)])
        arrays = {"var": cat("running_var"), "mean": cat("running_mean"),
                  "scale": cat("bn.weight"), "bias": cat("bn.bias")}
        c = len(arrays["var"])
        assert c > 40000
    j = {k: jnp.asarray(v.astype(np.float32), jnp.dtype(stats))
         for k, v in arrays.items()}
    x = rng.normal(0, 3, (2, 3, 5, c)).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(x_dtype))
    flax_bn = fnn.BatchNorm(use_running_average=True, epsilon=1e-3,
                            dtype=jnp.dtype(x_dtype))
    variables = {"params": {"scale": j["scale"], "bias": j["bias"]},
                 "batch_stats": {"mean": j["mean"], "var": j["var"]}}
    ref = np.asarray(jax.jit(flax_bn.apply)(variables, xj), np.float32)
    op_by_op = np.asarray(flax_bn.apply(variables, xj), np.float32)
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, stats))
    bn = BatchNorm(c)
    bn.load_state_dict({"weight": to_t(j["scale"]), "bias": to_t(j["bias"]),
                        "running_mean": to_t(j["mean"]),
                        "running_var": to_t(j["var"])})
    bn = bn.to(getattr(torch, x_dtype))
    assert bn.stats_dtype == getattr(torch, stats)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(
        getattr(torch, x_dtype)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = bn(xt).permute(0, 2, 3, 1).float().numpy()
    if case == "float32":
        np.testing.assert_allclose(got, ref, rtol=2.4e-7, atol=2e-6)
    elif case == "folded bf16":
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, op_by_op)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        assert np.abs(got - op_by_op).max() > 1e-2
