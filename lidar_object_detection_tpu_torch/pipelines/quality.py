"""The serving-quality protocol: how the committed serving point was chosen.

    python -m lidar_object_detection_tpu_torch.pipelines.quality knob-sweep \\
        --ckpt checkpoints/yolo11x_seg_distill.msgpack --dataset ROOT \\
        --out knob_sweep.json [--guarded-grid 0.99:0.5:200] \\
        [--tta-grid 0.99:0.5:200] [--device cpu]
    python -m lidar_object_detection_tpu_torch.pipelines.quality \\
        threshold-cv --dataset ROOT --guarded-grid 0.99:0.5:200
    python -m lidar_object_detection_tpu_torch.pipelines.quality flip-probe \\
        --dataset ROOT
    python -m lidar_object_detection_tpu_torch.pipelines.quality \\
        imgsz-probe --dataset ROOT --imgsz 640 1408

Counterpart of ``examples/quality_common.py`` (the shared protocol) and of
the four studies built on it, one subcommand each, with their flags,
defaults, printed lines and JSON payloads:

* ``knob-sweep`` (``quality_knob_sweep.py``): detector confidence x mask
  threshold x upsample space x threshold mode, plus guarded-shrink and
  hflip-TTA operating points;
* ``threshold-cv`` (``quality_threshold_cv.py``): leave-one-frame-out
  selection of the configuration under the ``argmax``, ``guarded`` and
  ``coverage`` rules, so that no car scores the configuration that was
  chosen on it;
* ``flip-probe`` (``quality_flip_probe.py``): each operating point single
  view (``baseline``), from the mirrored view alone (``flipped``) and as
  the hflip consensus serves it (``averaged``);
* ``imgsz-probe`` (``quality_imgsz_probe.py``): one study per letterbox
  size, each freed before the next.

The protocol: the network runs once over every frame of the tree, in one
batch (a second time on the mirrored frames where a configuration needs
both views).  Each configuration then decodes those raw outputs (NMS,
kernel K5; mask assembly, K3 / K2 / the peak pass) and runs both fusion
passes of the erosion study (no erosion, then eroded: kernel K1 each) and
joins their matched cars (``eval/erosion_study.join_runs``).

``--dataset`` defaults to ``$LIDAR_TPU_KITTI360``; one of them is
required.  Everything runs on the card unless ``--device cpu`` is given
(``--platform`` is the JAX scripts' spelling); without a card and without
that flag the command refuses.  ``--out`` defaults to a file in the
temporary directory, as the JAX scripts' ``/tmp`` paths.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, PipelineVersion)
from lidar_object_detection_tpu_torch.data import Kitti360Dataset
from lidar_object_detection_tpu_torch.eval.erosion_study import (
    analyze, join_runs)
from lidar_object_detection_tpu_torch.models.common import full_float32
from lidar_object_detection_tpu_torch.models.yolo.postprocess import (
    PostprocessParams, letterbox_image, mask_prob_fields,
    pack_thresholded_masks, postprocess_batch)
from lidar_object_detection_tpu_torch.models.yolo.serving import (
    load_serving_checkpoint)
from lidar_object_detection_tpu_torch.models.yolo.tta import (
    flip_boxes, postprocess_tta)
from lidar_object_detection_tpu_torch.pipelines.cli import (
    common_flags, require_dataset)
from lidar_object_detection_tpu_torch.pipelines.runner import FusionPipeline

REFERENCE_INSIDE_PCT = 74.48


# ---------------------------------------------------------------------------
# the shared protocol (examples/quality_common.py)
# ---------------------------------------------------------------------------

def network_outputs(det, images):
    """The raw outputs of ``det``'s network over (B, H0, W0, 3) uint8
    frames, one view (the study decodes them itself, so the detector's
    own TTA is not applied), in full float32 for a float32 network."""
    imgs = torch.as_tensor(np.ascontiguousarray(images)).to(det.device)
    imgs = imgs.to(torch.float32) / 255.0
    scope = (full_float32() if det.dtype == torch.float32
             else contextlib.nullcontext())
    with torch.no_grad(), scope:
        return det.model(letterbox_image(imgs, det.spec).to(det.dtype))


def prepare_study(ckpt: str, dataset: str, device="cuda", log=print,
                  **detector_kw) -> SimpleNamespace:
    """Load the checkpoint, build the two fusion pipelines, and run the
    network once over every frame of ``dataset``.

    Extra keyword args go to ``YoloDetector`` (e.g. ``imgsz=896``); the
    forward and every :func:`rows_for` decode then run at that detector's
    letterbox.
    """
    det0, _, resolved = load_serving_checkpoint(ckpt, device=device,
                                                **detector_kw)
    cfg_raw = FusionConfig.for_version(PipelineVersion.V2_STATS)
    cfg_ero = FusionConfig.for_version(PipelineVersion.CSV_EVAL)
    ds = Kitti360Dataset(dataset, shapes=cfg_raw.shapes)
    records = ds.load_frames()
    batch = ds.make_batch(records)
    images = ds.load_images(batch)
    spec = det0.spec
    log(f"[quality] {len(records)} frames, ckpt={ckpt} "
        f"({resolved['scale']}, letterbox {spec.dst_h}x{spec.dst_w})",
        flush=True)

    t0 = time.time()
    raw_out = network_outputs(det0, images)
    _sync(det0.device)
    log(f"[quality] forward pass: {time.time() - t0:.1f}s", flush=True)

    return SimpleNamespace(
        scale=resolved["scale"], n_frames=len(records), spec=spec,
        raw_out=raw_out, det=det0, images=images,
        run_forward=lambda imgs: network_outputs(det0, imgs),
        pipe_raw=FusionPipeline(ds, cfg_raw, det0, device=device),
        pipe_ero=FusionPipeline(ds, cfg_ero, det0, device=device))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _params(ctx, conf, mask_threshold, **kw) -> PostprocessParams:
    """The study's decode: the detector's letterbox, ``max_detections``
    32 and the library's other defaults (not the detector's own)."""
    return PostprocessParams(spec=ctx.spec, conf_threshold=conf,
                             mask_threshold=mask_threshold,
                             max_detections=32, **kw)


def rows_for(ctx: SimpleNamespace, conf: float, mask_threshold: float,
             upsample: str = "prob", threshold_mode: str = "absolute",
             floor: float | None = None, min_pixels: int = 0):
    """Decode at one configuration and run both fusion passes; the
    matched-in-both joined per-car rows (``join_runs``)."""
    pp = _params(ctx, conf, mask_threshold, mask_upsample=upsample,
                 mask_threshold_mode=threshold_mode,
                 mask_threshold_floor=floor, mask_min_pixels=min_pixels)
    return _joined_rows(ctx, postprocess_batch(ctx.raw_out, pp))


def _joined_rows(ctx: SimpleNamespace, detections):
    run_r = ctx.pipe_raw.run(detections=detections)
    run_e = ctx.pipe_ero.run(detections=detections)
    return join_runs(run_r.csv_rows, run_e.csv_rows)


def prepare_flip(ctx: SimpleNamespace, log=print) -> None:
    """Run the mirrored-view forward once and keep it on the study
    context (the flip-TTA configurations need both views)."""
    t0 = time.time()
    ctx.flip_out = ctx.run_forward(ctx.images[:, :, ::-1, :])
    _sync(ctx.det.device)
    log(f"[quality] mirrored forward: {time.time() - t0:.1f}s", flush=True)


def tta_detections(ctx: SimpleNamespace, conf: float, mask_threshold: float,
                   floor: float | None = None, min_pixels: int = 0,
                   mode: str = "averaged", match_iou: float = 0.5):
    """Flip-TTA detections of the study's frames.

    ``mode="averaged"`` is the serving consensus (``models/yolo/tta.py``
    ``postprocess_tta``, which ``postprocess_tta_pair`` runs for one
    frame and ``YoloDetector(tta="hflip")`` for a batch): both views
    decoded, the mirrored view's probability tables mirrored back and
    averaged per IoU-matched detection before the binarization; every
    step is per frame, and the batch takes one launch of each kernel.
    ``mode="flipped"`` gives the mirrored view's detections alone, mapped
    back: its probability fields mirrored, binarized by
    ``pack_thresholded_masks``."""
    if getattr(ctx, "flip_out", None) is None:
        prepare_flip(ctx)
    spec = ctx.spec
    pp = _params(ctx, conf, mask_threshold, mask_threshold_floor=floor,
                 mask_min_pixels=min_pixels)

    if mode == "averaged":
        both = {k: [torch.cat([a, b]) for a, b in zip(v, ctx.flip_out[k])]
                if isinstance(v, list) else torch.cat([v, ctx.flip_out[k]])
                for k, v in ctx.raw_out.items()}
        return postprocess_tta(both, pp, match_iou)

    if mode != "flipped":
        raise ValueError(f"mode must be 'averaged' or 'flipped', got "
                         f"{mode!r}")
    det_f = postprocess_batch(ctx.flip_out, pp, masks=False)
    boxes_f = flip_boxes(det_f["boxes"], float(spec.src_w))
    # frame by frame: a frame's fields are D x H0 x W0 float32
    bits = torch.stack([pack_thresholded_masks(
        mask_prob_fields(ctx.flip_out["proto"][b], det_f["coef"][b],
                         spec).flip(-1),
        boxes_f[b], det_f["det_valid"][b], mask_threshold, floor,
        min_pixels) for b in range(boxes_f.shape[0])])
    return {"boxes": boxes_f, "scores": det_f["scores"],
            "det_valid": det_f["det_valid"], "mask_bits": bits}


def rows_for_tta(ctx: SimpleNamespace, conf: float, mask_threshold: float,
                 floor: float | None = None, min_pixels: int = 0,
                 mode: str = "averaged", match_iou: float = 0.5):
    """The flip-TTA counterpart of :func:`rows_for`: the same protocol and
    joined rows, detections from :func:`tta_detections`."""
    return _joined_rows(ctx, tta_detections(
        ctx, conf, mask_threshold, floor, min_pixels, mode, match_iou))


def _parse_point(spec_str: str):
    """``THR:FLOOR:MINPIX`` -> (thr, floor or None, min_pixels)."""
    thr_s, floor_s, pix_s = spec_str.split(":")
    return (float(thr_s), float(floor_s) if floor_s else None,
            int(pix_s) if pix_s else 0)


def _write(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


# ---------------------------------------------------------------------------
# knob-sweep (examples/quality_knob_sweep.py)
# ---------------------------------------------------------------------------

def knob_sweep(args) -> None:
    ctx = prepare_study(args.ckpt, args.dataset, args.device)

    results = []
    for conf, mthr, ups, mode in itertools.product(
            args.conf, args.mask_thr, args.upsample, args.thr_mode):
        if mode == "relative" and ups != "prob":
            continue    # undefined combination (the decode refuses it)
        t0 = time.time()
        res = analyze(rows_for(ctx, conf, mthr, ups, mode))
        row = {"conf": conf, "mask_threshold": mthr, "upsample": ups,
               "thr_mode": mode,
               **res.summary(), "sweep_s": round(time.time() - t0, 1)}
        results.append(row)
        print(f"[sweep] {json.dumps(row)}", flush=True)

    for tta, grid in (("none", args.guarded_grid), ("hflip", args.tta_grid)):
        for spec_str in grid:
            thr, floor, pix = _parse_point(spec_str)
            t0 = time.time()
            fn = rows_for_tta if tta == "hflip" else rows_for
            res = analyze(fn(ctx, args.conf[0], thr, floor=floor,
                             min_pixels=pix))
            row = {"conf": args.conf[0], "mask_threshold": thr,
                   "mask_threshold_floor": floor,
                   "mask_min_pixels": pix, "tta": tta,
                   **res.summary(), "sweep_s": round(time.time() - t0, 1)}
            results.append(row)
            print(f"[sweep] {json.dumps(row)}", flush=True)

    results.sort(key=lambda r: -r["mean_inside_pct_eroded"])
    payload = {"ckpt": args.ckpt, "scale": ctx.scale,
               "reference_mean_inside_pct_eroded": REFERENCE_INSIDE_PCT,
               "baseline_row": {"conf": 0.25, "mask_threshold": 0.5},
               "results": results}
    _write(args.out, payload)

    print("\n| conf | mask_thr | matched | inside%% ero | inside%% raw | "
          "gain | std |")
    print("|---|---|---|---|---|---|---|")
    for r in results:
        print(f"| {r['conf']} | {r['mask_threshold']} | {r['matched_cars']} "
              f"| {r['mean_inside_pct_eroded']} | {r['mean_inside_pct_raw']} "
              f"| {r['mean_pct_improvement']} | {r['std_inside_pct_diff']} |")
    print(f"\n[sweep] best: {json.dumps(results[0])} -> {args.out}")


# ---------------------------------------------------------------------------
# threshold-cv (examples/quality_threshold_cv.py)
# ---------------------------------------------------------------------------

def select_threshold(rows_by_thr, thresholds, train_frames, rule, guard):
    """Pick a configuration using only the rows whose frame is in
    ``train_frames``.

    ``thresholds`` may be plain floats or any hashable configuration keys;
    the ``guarded`` rule's 0.5 baseline applies to float grids only,
    ``argmax`` and ``coverage`` work for any key.  Ties keep the earliest
    configuration of ``thresholds``."""
    def train_rows(thr):
        return [r for r in rows_by_thr[thr] if r.frame in train_frames]

    candidates = list(thresholds)
    if rule == "coverage":
        # only the configurations that keep the MOST matched cars on the
        # training frames compete: a configuration may win by scoring
        # better, never by dropping hard cars
        counts = {t: len(train_rows(t)) for t in thresholds}
        top = max(counts.values())
        candidates = [t for t in thresholds if counts[t] == top]
    elif rule == "guarded":
        # the guard's baseline: ultralytics' 0.5 where swept, else the
        # lowest threshold (not the first listed)
        base_thr = 0.5 if 0.5 in thresholds else min(thresholds)
        base = len(train_rows(base_thr))
        candidates = [t for t in thresholds
                      if len(train_rows(t)) >= base - guard]
        if not candidates:
            candidates = list(thresholds)
    best, best_mean = candidates[0], -1.0
    for t in candidates:
        rows = train_rows(t)
        if not rows:
            continue
        m = float(np.mean([r.inside_pct_eroded for r in rows]))
        if m > best_mean:
            best, best_mean = t, m
    return best


def cv_aggregate(rows_by_thr, thresholds, frames, rule, guard):
    """Leave one frame out: select on the other frames, score the held-out
    frame's rows at the selection."""
    held_rows, picks = [], {}
    for f in frames:
        train = set(frames) - {f}
        thr = select_threshold(rows_by_thr, thresholds, train, rule, guard)
        picks[f] = thr
        held_rows.extend(r for r in rows_by_thr[thr] if r.frame == f)
    mean_ero = float(np.mean([r.inside_pct_eroded for r in held_rows]))
    mean_raw = float(np.mean([r.inside_pct_raw for r in held_rows]))
    diffs = [r.inside_pct_diff for r in held_rows]
    return {
        "rule": rule,
        "matched_cars": len(held_rows),
        "mean_inside_pct_eroded": round(mean_ero, 2),
        "mean_inside_pct_raw": round(mean_raw, 2),
        "std_inside_pct_diff": round(float(np.std(diffs, ddof=1)), 2),
        "fold_picks": {str(f): picks[f] for f in frames},
    }


def threshold_cv(args) -> None:
    ctx = prepare_study(args.ckpt, args.dataset, args.device)

    # configuration keys: plain floats, or label strings of the mixed
    # grid (JSON keys in fold_picks)
    configs = list(args.mask_thr)
    guarded_cfgs, tta_cfgs = {}, {}

    def parse_cfg(spec_str):
        thr_s, floor_s, pix_s = spec_str.split(":")
        parsed = _parse_point(spec_str)
        label = (f"{thr_s}+floor{floor_s}@{pix_s}" if parsed[1] is not None
                 else thr_s)
        return label, parsed

    for spec_str in args.guarded_grid:
        key, parsed = parse_cfg(spec_str)
        guarded_cfgs[key] = parsed
        configs.append(key)
    for spec_str in args.tta_grid:
        key, parsed = parse_cfg(spec_str)
        key = "tta:" + key
        tta_cfgs[key] = parsed
        configs.append(key)

    rows_by_thr, insample = {}, []
    for cfg in configs:
        t0 = time.time()
        if cfg in tta_cfgs:
            thr, floor, pix = tta_cfgs[cfg]
            rows = rows_for_tta(ctx, args.conf, thr, floor=floor,
                                min_pixels=pix)
        elif cfg in guarded_cfgs:
            thr, floor, pix = guarded_cfgs[cfg]
            rows = rows_for(ctx, args.conf, thr, floor=floor,
                            min_pixels=pix)
        else:
            rows = rows_for(ctx, args.conf, cfg)
        rows_by_thr[cfg] = rows
        row = {"config": cfg, **analyze(rows).summary(),
               "config_s": round(time.time() - t0, 1)}
        insample.append(row)
        print(f"[cv] {json.dumps(row)}", flush=True)

    frames = sorted({r.frame for rows in rows_by_thr.values() for r in rows})
    # the guarded rule's 0.5 baseline is for float grids; the mixed grid
    # runs the coverage rule in its place
    rules = (("coverage", "argmax") if (guarded_cfgs or tta_cfgs)
             else ("guarded", "argmax"))
    results = [cv_aggregate(rows_by_thr, configs, frames, rule, args.guard)
               for rule in rules]
    payload = {"ckpt": args.ckpt, "scale": ctx.scale,
               "reference_mean_inside_pct_eroded": REFERENCE_INSIDE_PCT,
               "n_frames": len(frames), "thresholds": configs,
               "insample": insample, "cv": results}
    _write(args.out, payload)

    for res in results:
        # floats, then labels: a mixed grid's picks can be both (the JAX
        # script's plain sort raises there)
        picks = sorted(set(res["fold_picks"].values()),
                       key=lambda k: (isinstance(k, str), k))
        print(f"\n[cv] rule={res['rule']}: mean inside-% eroded "
              f"{res['mean_inside_pct_eroded']} over {res['matched_cars']} "
              f"held-out cars (raw {res['mean_inside_pct_raw']}, "
              f"std {res['std_inside_pct_diff']}); fold picks {picks}")
    print(f"[cv] reference: {REFERENCE_INSIDE_PCT} -> {args.out}")


# ---------------------------------------------------------------------------
# flip-probe (examples/quality_flip_probe.py)
# ---------------------------------------------------------------------------

def flip_probe(args) -> None:
    ctx = prepare_study(args.ckpt, args.dataset, args.device)
    prepare_flip(ctx)

    results = []
    for spec_str in args.configs:
        thr, floor, min_pix = _parse_point(spec_str)
        for mode in ("baseline", "flipped", "averaged"):
            t0 = time.time()
            if mode == "baseline":
                rows = rows_for(ctx, args.conf, thr, floor=floor,
                                min_pixels=min_pix)
            else:
                rows = rows_for_tta(ctx, args.conf, thr, floor=floor,
                                    min_pixels=min_pix, mode=mode,
                                    match_iou=args.match_iou)
            row = {"mode": mode, "mask_threshold": thr,
                   "floor": floor, "min_pixels": min_pix,
                   **analyze(rows).summary(),
                   "sweep_s": round(time.time() - t0, 1)}
            results.append(row)
            print(f"[flip] {json.dumps(row)}", flush=True)

    payload = {"ckpt": args.ckpt, "match_iou": args.match_iou,
               "reference_mean_inside_pct_eroded": REFERENCE_INSIDE_PCT,
               "results": results}
    _write(args.out, payload)
    print(f"[flip] -> {args.out}")


# ---------------------------------------------------------------------------
# imgsz-probe (examples/quality_imgsz_probe.py)
# ---------------------------------------------------------------------------

def imgsz_probe(args) -> None:
    results = []
    for s in args.imgsz:
        t0 = time.time()
        ctx = prepare_study(args.ckpt, args.dataset, args.device, imgsz=s)
        fwd_s = round(time.time() - t0, 1)
        configs = [
            {"mask_threshold": t} for t in args.mask_thr
        ] + [
            {"mask_threshold": float(g.split(":")[0]),
             "floor": float(g.split(":")[1]),
             "min_pixels": int(g.split(":")[2])}
            for g in args.guarded
        ]
        for cfg in configs:
            t0 = time.time()
            res = analyze(rows_for(
                ctx, args.conf, cfg["mask_threshold"],
                floor=cfg.get("floor"),
                min_pixels=cfg.get("min_pixels", 0)))
            row = {"imgsz": s, "conf": args.conf, **cfg,
                   **res.summary(),
                   "forward_s": fwd_s,
                   "sweep_s": round(time.time() - t0, 1)}
            results.append(row)
            print(f"[imgsz] {json.dumps(row)}", flush=True)
        # free the raw outputs before the next (larger) size
        del ctx
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()

    results.sort(key=lambda r: -r["mean_inside_pct_eroded"])
    payload = {"ckpt": args.ckpt,
               "reference_mean_inside_pct_eroded": REFERENCE_INSIDE_PCT,
               "committed_serving_point": {
                   "imgsz": 640, "mask_threshold": 0.99,
                   "floor": 0.5, "min_pixels": 200},
               "results": results}
    _write(args.out, payload)

    print("\n| imgsz | mask_thr | guarded | matched | inside% ero | raw |")
    print("|---|---|---|---|---|---|")
    for r in results:
        guarded = (f"{r['floor']}@{r['min_pixels']}"
                   if r.get("floor") is not None else "-")
        print(f"| {r['imgsz']} | {r['mask_threshold']} | {guarded} "
              f"| {r['matched_cars']} | {r['mean_inside_pct_eroded']} "
              f"| {r['mean_inside_pct_raw']} |")
    print(f"\n[imgsz] best: {json.dumps(results[0])} -> {args.out}")


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _tmp(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def _point_grid(p, flag: str, help_text: str) -> None:
    p.add_argument(flag, nargs="*", default=[], metavar="THR:FLOOR:MINPIX",
                   help=help_text)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_object_detection_tpu_torch.pipelines.quality",
        description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    ks = sub.add_parser("knob-sweep", help="in-sample sweep of the "
                                           "serving knobs")
    ks.add_argument("--ckpt",
                    default="checkpoints/yolo11x_seg_distill.msgpack")
    ks.add_argument("--out", default=_tmp("knob_sweep.json"))
    ks.add_argument("--conf", type=float, nargs="*", default=[0.25])
    ks.add_argument("--mask-thr", type=float, nargs="*",
                    default=[0.5, 0.6, 0.7, 0.8])
    ks.add_argument("--upsample", nargs="*", default=["prob"],
                    choices=["prob", "logit"],
                    help="mask upsample space(s) to sweep")
    ks.add_argument("--thr-mode", nargs="*", default=["absolute"],
                    choices=["absolute", "relative"],
                    help="threshold application mode(s): absolute cut vs "
                         "fraction of each instance's peak probability")
    _point_grid(ks, "--guarded-grid",
                "additional guarded-shrink configs (mask_threshold_floor "
                "decode mode), e.g. 0.99:0.5:200 -- swept as extra rows "
                "alongside the plain grid")
    _point_grid(ks, "--tta-grid",
                "additional hflip-TTA configs (two-view mask consensus, "
                "models/yolo/tta.py), e.g. 0.99:0.5:200 -- empty floor for "
                'a plain threshold; rows carry "tta": "hflip"')

    cv = sub.add_parser("threshold-cv", help="leave-one-frame-out "
                                             "validation of the choice")
    cv.add_argument("--ckpt",
                    default="checkpoints/yolo11x_seg_distill.msgpack")
    cv.add_argument("--out", default=_tmp("thr_cv.json"))
    cv.add_argument("--conf", type=float, default=0.25)
    cv.add_argument("--mask-thr", type=float, nargs="*",
                    default=[0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95, 0.99])
    cv.add_argument("--guard", type=int, default=2,
                    help="guarded rule: max matched-car drop vs the 0.5 "
                         "default allowed on the training frames")
    _point_grid(cv, "--guarded-grid",
                "additional guarded-shrink configs, e.g. 0.99:0.5:200; "
                "when given, the CV runs over the mixed plain+guarded grid "
                "with the coverage and argmax rules")
    _point_grid(cv, "--tta-grid",
                "additional flip-TTA configs, e.g. 0.99:0.5:200 -- empty "
                "floor for a plain threshold. Mixed-grid rules apply as "
                "with --guarded-grid")

    fp = sub.add_parser("flip-probe", help="baseline, mirrored and "
                                           "averaged views")
    fp.add_argument("--ckpt",
                    default="checkpoints/yolo11n_seg_distill.msgpack")
    fp.add_argument("--out", default=_tmp("flip_probe.json"))
    fp.add_argument("--conf", type=float, default=0.25)
    fp.add_argument("--configs", nargs="*", default=["0.9::", "0.99:0.5:200"],
                    metavar="THR:FLOOR:MINPIX",
                    help="operating points (empty floor = plain threshold)")
    fp.add_argument("--match-iou", type=float, default=0.5)

    ip = sub.add_parser("imgsz-probe", help="one study per letterbox size")
    ip.add_argument("--ckpt",
                    default="checkpoints/yolo11n_seg_distill.msgpack")
    ip.add_argument("--out", default=_tmp("imgsz_probe.json"))
    ip.add_argument("--imgsz", type=int, nargs="*", default=[640, 896, 1408])
    ip.add_argument("--mask-thr", type=float, nargs="*",
                    default=[0.5, 0.9, 0.99],
                    help="plain thresholds per size")
    ip.add_argument("--guarded", nargs="*", default=["0.99:0.5:200"],
                    metavar="THR:FLOOR:MINPIX",
                    help="guarded-shrink configs per size (mask_min_pixels "
                         "counts native-resolution pixels, so it does not "
                         "depend on imgsz)")
    ip.add_argument("--conf", type=float, default=0.25)

    for p in (ks, cv, fp, ip):
        common_flags(p)
    return ap


STUDIES = {"knob-sweep": knob_sweep, "threshold-cv": threshold_cv,
           "flip-probe": flip_probe, "imgsz-probe": imgsz_probe}


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    require_dataset(ap, args)
    STUDIES[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
