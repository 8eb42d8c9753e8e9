"""The port's serving slice as a whole against the JAX package, on the CPU:
``YoloDetector(tta="hflip")`` at the n checkpoint's sidecar point (0.99 +
floor 0.5 at 200 px) -> ``fuse_batch`` -> ``frame_statistics``.

The source is two 96 x 320 crops of a real KITTI-360 camera frame with
cars in them, served at ``imgsz=160``.  Stated tolerances:

* boxes within 1e-3 px and scores within 1e-5: the float32 network sums
  its convolutions in another order (measured 8e-5 px and 6e-7);
* ``det_valid`` equal;
* packed mask words: at most 1e-3 of the words may differ, for pixels
  whose interpolated probability lies within float32 rounding of a cut
  (measured 0 on these frames);
* feeding the JAX mask words into both fusions gives equal rows.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.eval.statistics import (
    frame_statistics as jframe_statistics)
from lidar_object_detection_tpu.fusion.associate import (
    FusionParams as JFusionParams, fuse_batch as jfuse_batch)
from lidar_object_detection_tpu.models.yolo.serving import (
    load_serving_checkpoint as jload)
from lidar_object_detection_tpu_torch.config import FusionParams
from lidar_object_detection_tpu_torch.eval.statistics import (
    frame_statistics, summarize)
from lidar_object_detection_tpu_torch.fusion.associate import fuse_batch
from lidar_object_detection_tpu_torch.models.yolo.serving import (
    load_serving_checkpoint)
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

CKPT = "checkpoints/yolo11n_seg_distill.msgpack"
H0, W0 = 96, 320
# a pinhole camera for the 96 x 320 crops, and the KITTI axis swap
K = np.array([[140.0, 0.0, 160.0], [0.0, 140.0, 48.0], [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def both():
    frame = read_png_rgb(chip_smoke.FRAMES[0])
    images = np.ascontiguousarray(np.stack(
        [frame[180:276, 528:848], frame[180:276, 352:672]]))
    jdet, jstep, jres = jload(CKPT, (H0, W0), imgsz=160)
    tdet, tstep, tres = load_serving_checkpoint(CKPT, (H0, W0), imgsz=160,
                                                device="cpu")
    assert jres == tres and jstep == tstep
    assert tres["tta"] == "hflip" and tres["mask_threshold_floor"] == 0.5
    ref = {k: np.asarray(v) for k, v in jdet.detect(images).items()}
    got = {k: v.numpy() for k, v in tdet.detect(images).items()}
    return images, ref, got


def test_detector_matches_jax(both):
    _, ref, got = both
    np.testing.assert_array_equal(got["det_valid"], ref["det_valid"])
    assert ref["det_valid"][0].sum() >= 2, "degenerate: too few cars"
    v = ref["det_valid"]
    np.testing.assert_allclose(got["boxes"][v], ref["boxes"][v], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0,
                               atol=1e-5)
    words = ref["mask_bits"].astype(np.uint32).view(np.int32)
    share = float((got["mask_bits"] != words).mean())
    assert share <= 1e-3, f"mask-word mismatch share {share}"
    assert (words != 0).any()


def test_letterbox_and_tta_decode_match_jax(both):
    """The same raw network outputs (the JAX network's, on the same
    letterboxed frames) decoded by both packages' TTA merges: equal
    validity and mask words, boxes to float32 rounding."""
    from lidar_object_detection_tpu.models.yolo.postprocess import (
        PostprocessParams as JParams, letterbox_image as jletterbox)
    from lidar_object_detection_tpu.models.yolo.tta import (
        postprocess_tta_pair as jpair)
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        PostprocessParams, letterbox_image, postprocess_single)
    from lidar_object_detection_tpu_torch.models.yolo.tta import (
        postprocess_tta_pair)

    images = both[0]
    jdet, _, res = jload(CKPT, (H0, W0), imgsz=160)
    spec = jdet.spec
    imgs = images.astype(np.float32) / np.float32(255.0)
    both_views = np.concatenate([imgs, imgs[:, :, ::-1]])
    lb_j = np.stack([np.asarray(jletterbox(jnp.asarray(im), spec))
                     for im in both_views])
    tdet, _, _ = load_serving_checkpoint(CKPT, (H0, W0), imgsz=160,
                                         device="cpu")
    lb_t = letterbox_image(torch.from_numpy(both_views.copy()), tdet.spec)
    np.testing.assert_allclose(lb_t.numpy(), lb_j, rtol=0, atol=1e-6)

    raw = jdet.model.apply(jdet.variables, jnp.asarray(lb_j))
    raw = {k: [np.asarray(x) for x in v] if isinstance(v, list)
           else np.asarray(v) for k, v in raw.items()}
    kw = dict(mask_threshold=res["mask_threshold"],
              mask_threshold_floor=res["mask_threshold_floor"],
              mask_min_pixels=res["mask_min_pixels"])
    jparams = JParams(spec=spec, **kw)
    tparams = PostprocessParams(spec=tdet.spec, **kw)
    n = len(images)
    for b in range(n):
        view = lambda i, wrap: {k: [wrap(x[i]) for x in v]
                                if isinstance(v, list) else wrap(v[i])
                                for k, v in raw.items()}
        ref = jpair(view(b, jnp.asarray), view(b + n, jnp.asarray), jparams)
        to_t = lambda a: torch.from_numpy(np.array(a))
        got = postprocess_tta_pair(view(b, to_t), view(b + n, to_t),
                                   tparams)
        np.testing.assert_array_equal(got["det_valid"].numpy(),
                                      np.asarray(ref["det_valid"]))
        np.testing.assert_allclose(got["boxes"].numpy(),
                                   np.asarray(ref["boxes"]), rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(
            got["mask_bits"].numpy(),
            np.asarray(ref["mask_bits"]).astype(np.uint32).view(np.int32))
        single = postprocess_single(view(b, to_t), tparams)
        np.testing.assert_array_equal(single["det_valid"].numpy(),
                                      np.asarray(ref["det_valid"]))
        assert single["mask_bits"].shape == (H0, W0)


def test_tta_decode_runs_one_nms_for_both_views(both, monkeypatch):
    """The TTA decode takes both views' candidates in one NMS call; its
    boxes, scores and mask words equal those of one NMS call per view."""
    from lidar_object_detection_tpu_torch.models.yolo import (
        postprocess as tpp, tta as ttta)

    images = both[0]
    tdet, _, _ = load_serving_checkpoint(CKPT, (H0, W0), imgsz=160,
                                         device="cpu")
    outputs = tdet.forward(images)
    calls = []
    real_nms = tpp.nms
    monkeypatch.setattr(tpp, "nms", lambda *a: calls.append(
        a[0].shape[0]) or real_nms(*a))
    got = tdet.decode(outputs)
    assert calls == [2 * len(images)]
    # one NMS call per view, then the same merge
    n = len(images)
    view = lambda sl: {k: [x[sl] for x in v] if isinstance(v, list)
                       else v[sl] for k, v in outputs.items()}
    det_n = tpp.postprocess_batch(view(slice(0, n)), tdet.params,
                                  masks=False)
    det_f = tpp.postprocess_batch(view(slice(n, None)), tdet.params,
                                  masks=False)
    assert calls == [2 * n, n, n]
    det = {k: torch.cat([det_n[k], det_f[k]]) for k in det_n}
    table = ttta.consensus_tables(det, outputs["proto"], tdet.params,
                                  tdet.tta_match_iou)
    bits = tpp._finish_masks(table, det_n["boxes"], det_n["det_valid"],
                             tdet.params)
    assert torch.equal(got["mask_bits"], bits)
    for key in ("boxes", "scores", "det_valid"):
        assert torch.equal(got[key], det_n[key])
    assert int(got["det_valid"].sum()) > 0


def _raw_jax_outputs(images):
    """The JAX network's raw outputs on both views of ``images`` (the
    mirrors last), as numpy, and the JAX detector and its serving point."""
    from lidar_object_detection_tpu.models.yolo.postprocess import (
        letterbox_image as jletterbox)

    jdet, _, res = jload(CKPT, (H0, W0), imgsz=160)
    imgs = images.astype(np.float32) / np.float32(255.0)
    both_views = np.concatenate([imgs, imgs[:, :, ::-1]])
    lb = np.stack([np.asarray(jletterbox(jnp.asarray(im), jdet.spec))
                   for im in both_views])
    raw = jdet.model.apply(jdet.variables, jnp.asarray(lb))
    raw = {k: [np.asarray(x) for x in v] if isinstance(v, list)
           else np.asarray(v) for k, v in raw.items()}
    return raw, jdet, res


def test_batched_tta_decode_matches_jax_frame_by_frame(both):
    """The port's TTA decode of the whole batch (one NMS, one merge, one
    mask assembly) against the JAX package's ``tta`` decode of each frame
    on the same raw outputs: equal validity and mask words, boxes to
    float32 rounding."""
    from lidar_object_detection_tpu.models.yolo.postprocess import (
        PostprocessParams as JParams)
    from lidar_object_detection_tpu.models.yolo.tta import (
        postprocess_tta_pair as jpair)
    from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
        PostprocessParams)
    from lidar_object_detection_tpu_torch.models.yolo.tta import (
        postprocess_tta)

    images = both[0]
    raw, jdet, res = _raw_jax_outputs(images)
    kw = dict(mask_threshold=res["mask_threshold"],
              mask_threshold_floor=res["mask_threshold_floor"],
              mask_min_pixels=res["mask_min_pixels"])
    tdet, _, _ = load_serving_checkpoint(CKPT, (H0, W0), imgsz=160,
                                         device="cpu")
    to_t = lambda a: torch.from_numpy(np.array(a))
    got = postprocess_tta({k: [to_t(x) for x in v] if isinstance(v, list)
                           else to_t(v) for k, v in raw.items()},
                          PostprocessParams(spec=tdet.spec, **kw))
    n = len(images)
    assert got["mask_bits"].shape == (n, H0, W0)
    for b in range(n):
        view = lambda i: {k: [jnp.asarray(x[i]) for x in v]
                          if isinstance(v, list) else jnp.asarray(v[i])
                          for k, v in raw.items()}
        ref = jpair(view(b), view(b + n), JParams(spec=jdet.spec, **kw))
        np.testing.assert_array_equal(got["det_valid"][b].numpy(),
                                      np.asarray(ref["det_valid"]))
        np.testing.assert_allclose(got["boxes"][b].numpy(),
                                   np.asarray(ref["boxes"]), rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(
            got["mask_bits"][b].numpy(),
            np.asarray(ref["mask_bits"]).astype(np.uint32).view(np.int32))
    assert bool((got["mask_bits"] != 0).any())


@pytest.mark.parametrize("tta", ["hflip", "none"])
def test_decode_assembles_masks_once_per_batch(both, monkeypatch, tta):
    """The decode of a batch calls the count twin once and the assembly
    twin once (the kernels' stand-ins on the CPU), and no per-frame
    mask function; its words equal those of the unpatched decode."""
    from lidar_object_detection_tpu_torch.ops import mask_assembly as ma

    images = both[0]
    tdet, _, _ = load_serving_checkpoint(CKPT, (H0, W0), imgsz=160,
                                         device="cpu")
    tdet.tta = tta
    outputs = tdet.forward(images)
    ref = tdet.decode(outputs)
    calls = []

    def spy(name, fn):
        def wrapped(ops, *args):
            calls.append((name, tuple(ops.table.shape[:2])))
            return fn(ops, *args)
        return wrapped

    monkeypatch.setattr(ma, "count_above_plain",
                        spy("count", ma.count_above_plain))
    monkeypatch.setattr(ma, "assemble_masks_plain",
                        spy("assemble", ma.assemble_masks_plain))
    for single in ("assemble_masks", "count_above",
                   "assemble_masks_guarded"):
        monkeypatch.setattr(ma, single, None)
    got = tdet.decode(outputs)
    d = tdet.params.max_detections
    n = len(images)
    assert calls == [("count", (n, d)), ("assemble", (n, d))]
    assert torch.equal(got["mask_bits"], ref["mask_bits"])


def test_fusion_statistics_match_jax(both):
    images, ref, got = both
    rng = np.random.default_rng(7)
    scenes = [chip_smoke.make_scene(rng, ref["boxes"][b],
                                    ref["det_valid"][b], num_points=8192,
                                    num_boxes=48, num_valid=40, intrinsics=K)
              for b in range(len(images))]
    stack = lambda i: np.stack([s[i] for s in scenes])
    points, pvalid, corners, bvalid = (stack(i) for i in range(4))
    calib = (chip_smoke.VELO_TO_RECT, chip_smoke.CAM_TO_VELO,
             K.astype(np.float32))
    kw = dict(width=W0, height=H0, num_detections=32, erosion_enabled=True)
    words = ref["mask_bits"].astype(np.uint32)

    jf = jfuse_batch(jnp.asarray(points), jnp.asarray(pvalid),
                     jnp.asarray(words), jnp.asarray(ref["det_valid"]),
                     jnp.asarray(corners), jnp.asarray(bvalid),
                     *(jnp.asarray(c) for c in calib),
                     params=JFusionParams(**kw))
    t = lambda a: torch.from_numpy(np.array(a))
    tf = fuse_batch(t(points), t(pvalid), t(words.view(np.int32)),
                    t(ref["det_valid"]), t(corners), t(bvalid),
                    *(t(c) for c in calib), params=FusionParams(**kw))
    # the port's own masks through the port's fusion too
    own = fuse_batch(t(points), t(pvalid), t(got["mask_bits"]),
                     t(got["det_valid"]), t(corners), t(bvalid),
                     *(t(c) for c in calib), params=FusionParams(**kw))
    rows_j, rows_t, rows_own = [], [], []
    for b in range(len(images)):
        rows_j += jframe_statistics(
            b, np.asarray(jf["total_points"][b]), np.asarray(jf["best_box"][b]),
            np.asarray(jf["points_inside"][b]), np.asarray(jf["matched"][b]),
            ref["det_valid"][b], np.asarray(jf["box_visible"][b]))
        rows_t += frame_statistics(
            b, tf["total_points"][b], tf["best_box"][b],
            tf["points_inside"][b], tf["matched"][b],
            t(ref["det_valid"][b]), tf["box_visible"][b])
        rows_own += frame_statistics(
            b, own["total_points"][b], own["best_box"][b],
            own["points_inside"][b], own["matched"][b],
            t(got["det_valid"][b]), own["box_visible"][b])
    assert [vars(r) for r in rows_t] == [vars(r) for r in rows_j]
    assert summarize(rows_t)["matched"] > 0
    if (got["mask_bits"] == words.view(np.int32)).all():
        assert [vars(r) for r in rows_own] == [vars(r) for r in rows_j]


def test_detector_runs_on_cuda_by_default_or_refuses():
    """The entry point defaults to the card; without one it raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        det, _, _ = load_serving_checkpoint(CKPT, (H0, W0), imgsz=160)
        assert next(det.model.parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        load_serving_checkpoint(CKPT, (H0, W0), imgsz=160)
