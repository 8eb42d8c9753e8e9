"""Regenerate the reference's artifact set behind a learned detector.

    python -m lidar_object_detection_tpu_torch.pipelines.regen_artifacts \\
        --ckpt checkpoints/yolo11n_seg_distill.msgpack --dataset ROOT \\
        [--out artifacts/learned_detector] [--device cpu]

Counterpart of ``examples/regen_artifacts.py``, with its flags, printed
lines and files.  It reruns every output of the reference's quality
evaluation through the port's pipelines with a committed detector
checkpoint, served at the operating point its sidecar records unless a
flag overrides a knob:

  out/
    master_car_statistics.csv          eroded-run rows (cvs_erosion schema)
    master_car_statistics_raw.csv      no-erosion rows
    erosion_study.csv                  joined per-car study rows
    master_car_statistics.csv.xlsx     3-sheet workbook (eval/xlsx.py)
    summary.json                       headline aggregates + run metadata
    depth_maps/                        per-car PNG figures (subset)
    seg_overlays/                      mask+box overlays (subset)

The erosion study and the two master CSVs run kernel K1 in each fusion
and the detector's kernels (K5, K3, K2) in each detection; the V5 check
on frame 100 runs the assignment kernel ``lap`` once.  The overlays are
written by the port's own PNG writer (``utils/png.py``), where the JAX
script uses PIL: the pixels are the same, the compressed bytes are not.
Frame 100 must be in the tree (the V5 check's frame, as in the JAX
script).  ``--dataset`` defaults to ``$LIDAR_TPU_KITTI360``; it runs on
the card unless ``--device cpu`` is given (``--platform`` is the JAX
script's spelling).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, PipelineVersion)
from lidar_object_detection_tpu_torch.data import Kitti360Dataset
from lidar_object_detection_tpu_torch.eval.erosion_study import (
    run_erosion_study)
from lidar_object_detection_tpu_torch.models.yolo.serving import (
    load_serving_checkpoint)
from lidar_object_detection_tpu_torch.ops.masks import unpack_masks
from lidar_object_detection_tpu_torch.pipelines.cli import (
    common_flags, require_dataset)
from lidar_object_detection_tpu_torch.pipelines.runner import FusionPipeline
from lidar_object_detection_tpu_torch.utils.png import (
    read_png_rgb, write_png_rgb)
from lidar_object_detection_tpu_torch.viz.overlay import (
    depth_map_figure, draw_boxes, golden_colors, overlay_masks)

V5_FRAME = 100


def build_detector(ckpt: str, conf: float = 0.25,
                   mask_threshold: float | None = None,
                   mask_threshold_floor: float | None = None,
                   mask_min_pixels: int | None = None,
                   tta: str | None = None, device="cuda"):
    """The detector serving ``ckpt`` on ``device`` and its step.  A knob
    left None takes the checkpoint sidecar's serving block, else the
    library default (``mask_threshold`` 0.5, ``tta`` none)."""
    det, step, _ = load_serving_checkpoint(
        ckpt, conf=conf, mask_threshold=mask_threshold,
        mask_threshold_floor=mask_threshold_floor,
        mask_min_pixels=mask_min_pixels, tta=tta, device=device)
    return det, step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_object_detection_tpu_torch.pipelines."
             "regen_artifacts", description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    common_flags(ap)
    ap.add_argument("--out", default="artifacts/learned_detector")
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--mask-thr", type=float, default=None,
                    help="mask binarization threshold (default: the "
                         "checkpoint sidecar's recorded serving point, "
                         "else 0.5)")
    ap.add_argument("--mask-floor", type=float, default=None,
                    help="guarded-shrink floor threshold override "
                         "(default: sidecar serving block)")
    ap.add_argument("--mask-min-pixels", type=int, default=None,
                    help="guarded-shrink pixel guard override")
    ap.add_argument("--tta", default=None, choices=["none", "hflip"],
                    help="test-time augmentation override (default: the "
                         "sidecar serving block; models/yolo/tta.py)")
    ap.add_argument("--depth-map-frames", type=int, nargs="*", default=[100])
    ap.add_argument("--overlay-frames", type=int, nargs="*",
                    default=[100, 2033])
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    require_dataset(ap, args)
    device = args.device

    os.makedirs(args.out, exist_ok=True)
    detector, step = build_detector(args.ckpt, args.conf, args.mask_thr,
                                    args.mask_floor, args.mask_min_pixels,
                                    args.tta, device=device)
    print(f"[regen] detector from {args.ckpt} (step {step}, "
          f"tta {detector.tta})", flush=True)

    # 1. the erosion study: both fusion runs behind one detection pass
    res = run_erosion_study(
        args.dataset, detector=detector,
        output_csv=os.path.join(args.out, "erosion_study.csv"),
        output_xlsx=os.path.join(args.out, "master_car_statistics.csv.xlsx"),
        device=device)
    summary = res.summary()
    print(f"[regen] erosion study: {summary}", flush=True)

    # the per-run master CSVs (cvs_erosion.py writes the eroded one)
    cfg_e = FusionConfig.for_version(PipelineVersion.CSV_EVAL)
    ds = Kitti360Dataset(args.dataset, shapes=cfg_e.shapes)
    run_e = FusionPipeline(ds, cfg_e, detector, device=device).run(
        master_csv=os.path.join(args.out, "master_car_statistics.csv"))
    cfg_r = FusionConfig.for_version(PipelineVersion.V2_STATS)
    run_r = FusionPipeline(ds, cfg_r, detector, device=device).run(
        master_csv=os.path.join(args.out, "master_car_statistics_raw.csv"))

    # 2. depth maps (seg_with_pointcloud figures)
    dm_dir = os.path.join(args.out, "depth_maps")
    os.makedirs(dm_dir, exist_ok=True)
    cfg_dm = FusionConfig.for_version(PipelineVersion.DEPTH_MAPS)
    pipe_dm = FusionPipeline(
        Kitti360Dataset(args.dataset, shapes=cfg_dm.shapes), cfg_dm,
        detector, device=device)
    n_dm = 0
    for fid, car, dm, seg in pipe_dm.depth_maps(args.depth_map_frames):
        depth_map_figure(
            dm, seg, car, fid,
            os.path.join(dm_dir, f"{fid:010d},depth_map_car_{car:02d}_.png"))
        n_dm += 1
    print(f"[regen] {n_dm} depth maps", flush=True)

    # 3. segmentation overlays (Imagesegmentation_final); image-only, so a
    # frame without boxes is covered too
    ov_dir = os.path.join(args.out, "seg_overlays")
    os.makedirs(ov_dir, exist_ok=True)
    ov_ids = [f for f in args.overlay_frames
              if os.path.exists(ds.image_path(f))]
    dropped = sorted(set(args.overlay_frames) - set(ov_ids))
    if dropped:
        print(f"[regen] WARNING: no image for overlay frames {dropped}; "
              "skipped", flush=True)
    if not ov_ids:
        raise SystemExit("regen: none of the requested overlay frames "
                         "have images")
    images = np.stack([read_png_rgb(ds.image_path(f)) for f in ov_ids])
    det_out = {k: v.cpu() for k, v in detector.detect(images).items()}
    for i, fid in enumerate(ov_ids):
        dv = det_out["det_valid"][i].numpy()
        n = int(dv.sum())
        colors = golden_colors(max(n, 1))
        masks = unpack_masks(det_out["mask_bits"][i], len(dv)).numpy()[dv]
        boxes = det_out["boxes"][i].float().numpy()[dv]
        vis = draw_boxes(overlay_masks(images[i], masks, colors),
                         boxes, colors)
        write_png_rgb(os.path.join(ov_dir, f"{fid:010d}.png"), vis)
    print(f"[regen] {len(ov_ids)} overlays", flush=True)

    # 4. V5 Hungarian check (matched pairs from the learned boxes)
    cfg5 = FusionConfig.for_version(PipelineVersion.V5_PROJECTED)
    run5 = FusionPipeline(
        Kitti360Dataset(args.dataset, shapes=cfg5.shapes), cfg5,
        detector, device=device).run([V5_FRAME])
    v5_pairs = sum(1 for p in run5.frames[0].matched_pairs
                   if not p.get("unmatched"))

    payload = {
        "checkpoint": args.ckpt, "ckpt_step": step, "conf": args.conf,
        "mask_threshold": detector.params.mask_threshold,
        "mask_threshold_floor": detector.params.mask_threshold_floor,
        "mask_min_pixels": detector.params.mask_min_pixels,
        "tta": detector.tta,
        "erosion_study": summary,
        "csv_eval": run_e.summary(),
        "no_erosion": run_r.summary(),
        "v5_frame100_matched_pairs": v5_pairs,
        "reference_baseline": {
            "mean_inside_pct_eroded": 74.48,
            "mean_pct_improvement": 7.67,
            "std_inside_point_diff": 5.87,
            "source": "master_car_statistics.csv.xlsx sheets Ero_stats / "
                      "Ero_vs_NoERo (reference workbook)",
        },
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps({k: payload[k] for k in
                      ("erosion_study", "csv_eval",
                       "v5_frame100_matched_pairs")}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
