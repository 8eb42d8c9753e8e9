"""The bf16 serving forward and decode of the port against the JAX
package's, on the CPU.

Both packages serve the committed n checkpoint with BatchNorm folded and
the network in bfloat16 (``load_serving_checkpoint(..., fold_weights=True,
dtype=bfloat16)``), at the sidecar's point (hflip TTA, 0.99 with floor 0.5
at 200 px), on four 96 x 320 crops of a real KITTI-360 camera frame served
at ``imgsz=160``.  The crops were fixed before any comparison was run; the
third holds no car.

bf16 keeps 8 bits of mantissa, and the two frameworks round at different
places: JAX normalises and letterboxes the frames in bf16 and runs its
folded BatchNorm in bf16, the port letterboxes in float32 and casts once.
So the tolerances are those of bf16 itself, measured on these crops
against each package's own float32 forward:

* the set of valid detections: equal;
* boxes within 4 px and scores within 0.06 (measured: port against JAX
  2.51 px and 0.032; JAX's own bf16 against its float32 2.64 px and
  0.040; one letterbox pixel at ``imgsz=160`` is two source pixels);
* packed mask words: at most 6 % of the words differ (measured 3.1 %; JAX
  bf16 against JAX float32 2.7 %): the masks are cut at 0.99, where a
  small change of the logit moves a mask's edge.

The second test answers whether bf16 drops detections that float32 keeps
at the 0.25 score cut: on these crops it drops none and adds none.  The
last test serves the two committed frames at full size (376 x 1408 at
``imgsz=640``, as the card serves them).  There bf16 drops detections
whose float32 score is near the cut, in both packages, and the port's
bf16 class logits drift from float32 about as far as JAX's do.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.models.yolo.postprocess import (
    letterbox_image as jletterbox)
from lidar_object_detection_tpu.models.yolo.serving import (
    load_serving_checkpoint as jload)
from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
    letterbox_image)
from lidar_object_detection_tpu_torch.models.yolo.serving import (
    load_serving_checkpoint)
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

CKPT = "checkpoints/yolo11n_seg_distill.msgpack"
H0, W0 = 96, 320
CROPS = ((180, 528), (180, 352), (150, 0), (200, 1000))


def _np(out):
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in out.items()}


@pytest.fixture(scope="module")
def served():
    frame = read_png_rgb(chip_smoke.FRAMES[0])
    images = np.ascontiguousarray(np.stack(
        [frame[y:y + H0, x:x + W0] for y, x in CROPS]))
    jdet, _, _ = jload(CKPT, (H0, W0), imgsz=160, fold_weights=True,
                       dtype=jnp.bfloat16)
    bf16, _, _ = load_serving_checkpoint(
        CKPT, (H0, W0), imgsz=160, device="cpu", dtype=torch.bfloat16,
        fold_weights=True)
    f32, _, _ = load_serving_checkpoint(CKPT, (H0, W0), imgsz=160,
                                        device="cpu")
    assert bf16.tta == "hflip"
    assert bf16.params.mask_threshold_floor == 0.5
    return {"jax": {k: np.asarray(v) for k, v in jdet.detect(images).items()},
            "bf16": _np(bf16.detect(images)), "f32": _np(f32.detect(images))}


def _compare(got, ref, box_tol, score_tol, word_share):
    np.testing.assert_array_equal(got["det_valid"], ref["det_valid"])
    v = ref["det_valid"]
    assert v.sum() >= 4, "degenerate: too few cars"
    np.testing.assert_allclose(got["boxes"][v], ref["boxes"][v], rtol=0,
                               atol=box_tol)
    np.testing.assert_allclose(got["scores"][v], ref["scores"][v], rtol=0,
                               atol=score_tol)
    words = np.asarray(ref["mask_bits"]).astype(np.uint32).view(np.int32)
    share = float((got["mask_bits"] != words).mean())
    assert share <= word_share, f"mask-word mismatch share {share}"
    assert (words != 0).any()


def test_bf16_serving_matches_jax(served):
    _compare(served["bf16"], served["jax"], box_tol=4.0, score_tol=0.06,
             word_share=0.06)


def test_bf16_keeps_the_float32_detections(served):
    """The port's bf16 against its own float32 on the same crops: the same
    detections pass the 0.25 cut.  Boxes within 5 px, scores within 0.1
    and at most 5 % of the mask words differ (measured 4.29 px, 0.071 and
    1.1 %)."""
    _compare(served["bf16"], served["f32"], box_tol=5.0, score_tol=0.1,
             word_share=0.05)


def _car_logits_jax(det, images):
    """The car-class logits of every anchor, frames normalised and
    letterboxed in the network's dtype as the JAX detector does."""
    import jax

    dt = det.model.dtype
    imgs = jnp.asarray(images).astype(dt) / jnp.asarray(255.0, dt)
    lb = jax.vmap(lambda im: jletterbox(im, det.spec))(imgs)
    out = det.model.apply(det.variables, lb)
    return np.concatenate([np.asarray(x, np.float32).reshape(
        len(images), -1, x.shape[-1]) for x in out["cls"]], 1)[..., 2]


def _car_logits_port(det, images):
    with torch.no_grad():
        lb = letterbox_image(torch.from_numpy(images).float() / 255.0,
                             det.spec)
        out = det.model(lb.to(det.dtype))
    return torch.cat([x.float().reshape(len(images), -1, x.shape[-1])
                      for x in out["cls"]], 1)[..., 2].numpy()


def test_bf16_at_full_size_drops_only_marginal_detections():
    """The two committed frames at full size.  Each package's bf16 against
    its own float32: the float32 detections that bf16 drops all score
    below 0.4 in float32 (measured: JAX drops one of 0.285, the port two of
    0.337 and 0.285, all in frame 100), and bf16 adds none.  Over the 256
    anchors of highest float32 car score per frame, the mean drift of the
    port's bf16 logits from float32 is at most 1.5 times JAX's (measured
    0.108 and 0.093)."""
    images = np.ascontiguousarray(np.stack(
        [read_png_rgb(p) for p in chip_smoke.FRAMES]))
    hw = images.shape[1:3]
    jdet = {"bf16": jload(CKPT, hw, fold_weights=True,
                          dtype=jnp.bfloat16)[0],
            "f32": jload(CKPT, hw)[0]}
    tdet = {"bf16": load_serving_checkpoint(CKPT, hw, device="cpu",
                                            dtype=torch.bfloat16,
                                            fold_weights=True)[0],
            "f32": load_serving_checkpoint(CKPT, hw, device="cpu")[0]}
    for name, dets, run in (
            ("jax", jdet, lambda d: {k: np.asarray(v).astype(np.float32)
                                     if k in ("boxes", "scores")
                                     else np.asarray(v)
                                     for k, v in d.detect(images).items()}),
            ("port", tdet, lambda d: _np(d.detect(images)))):
        lo, hi = run(dets["bf16"]), run(dets["f32"])
        for b in range(len(images)):
            bl = lo["boxes"][b][lo["det_valid"][b]]
            bh = hi["boxes"][b][hi["det_valid"][b]]
            sh = hi["scores"][b][hi["det_valid"][b]]
            iou = np.asarray(_iou(bh, bl))
            kept = (iou >= 0.5).any(axis=1) if len(bl) else \
                np.zeros(len(bh), bool)
            print(f"{name} frame {b}: float32 keeps {len(bh)}, bf16 "
                  f"{len(bl)}; float32 scores bf16 drops {sh[~kept]}")
            assert (sh[~kept] < 0.4).all(), (name, b, sh[~kept])
            if len(bl):
                assert (iou >= 0.5).any(axis=0).all(), (name, b)
    ref = _car_logits_jax(jdet["f32"], images)
    top = np.argsort(-ref, axis=1)[:, :256]
    drift = lambda v: float(np.abs(np.take_along_axis(v - ref, top, 1))
                            .mean())
    jax_drift = drift(_car_logits_jax(jdet["bf16"], images))
    port_drift = drift(_car_logits_port(tdet["bf16"], images))
    print(f"car-logit drift of bf16 from float32: port {port_drift:.4f}, "
          f"JAX {jax_drift:.4f}")
    assert drift(_car_logits_port(tdet["f32"], images)) < 1e-3
    assert 0 < port_drift <= 1.5 * jax_drift, (port_drift, jax_drift)


def _iou(a, b):
    """(N, 4) x (M, 4) xyxy IoU in numpy."""
    from lidar_object_detection_tpu_torch.geom.boxes import iou_2d_matrix

    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    return iou_2d_matrix(torch.from_numpy(a).double(),
                         torch.from_numpy(b).double()).numpy()
