"""Command-line interface of the port.

  python -m lidar_object_detection_tpu_torch run --version csv_eval \\
      --dataset /path/to/KITTI360_sample --detector yolo \\
      --weights checkpoints/yolo11n_seg_distill.msgpack --output results/
  python -m lidar_object_detection_tpu_torch run --version v5_projected \\
      --dataset /path/to/KITTI360_sample --output results/ \\
      --export-ply --analysis-cloud car_color
  python -m lidar_object_detection_tpu_torch erosion-study \\
      --dataset /path/to/KITTI360_sample --output results/
  python -m lidar_object_detection_tpu_torch depth-maps \\
      --dataset /path/to/KITTI360_sample --output Predictions/
  python -m lidar_object_detection_tpu_torch pointpillars-train \\
      --dataset /path/to/KITTI360_sample --surround --aggregate-sweeps \\
      --head ssd --max-points 131072 --checkpoint-dir ckpt/
  python -m lidar_object_detection_tpu_torch pointpillars-infer \\
      --dataset /path/to/KITTI360_sample \\
      --ckpt checkpoints/pp_ssd_surround.msgpack --surround \\
      --aggregate-sweeps --head ssd --export-ply
  python -m lidar_object_detection_tpu_torch pointpillars-export \\
      ckpt/pp_ssd_step8000.msgpack pp_ssd_slim.msgpack
  python -m lidar_object_detection_tpu_torch yolo-export \\
      run/yolo_x_distill.msgpack checkpoints/yolo11x_seg_distill.msgpack \\
      --serving-mask-thr 0.99 --serving-mask-floor 0.5 \\
      --serving-mask-min-pixels 200 --serving-tta hflip
  python -m lidar_object_detection_tpu_torch kitti2d \\
      --dataset /path/to/KITTI_Selection --output results/
  python -m lidar_object_detection_tpu_torch convert-weights \\
      --state-dict yolo11x-seg_state_dict.pt --output yolo11x.msgpack

Counterpart of ``lidar_object_detection_tpu/pipelines/cli.py``, every
subcommand.  ``--device`` (default ``cuda``) takes the place of the JAX
CLI's ``--platform``; ``--device cpu`` runs the plain twins on the CPU.

``pointpillars-train --checkpoint-dir DIR`` writes
``DIR/pp_<head>_step<N>.msgpack`` (flax's msgpack of ``(variables,
opt_state, step)``, the JAX surround runner's layout) with its sidecar
``.json``, where the JAX CLI writes an orbax directory: orbax imports
JAX, which the port does not.  ``pointpillars-infer --ckpt`` of either
package reads it.  ``pointpillars-export SRC DST`` keeps only such a
checkpoint's variables and step, as ``examples/export_pp_ckpt.py`` does.

``--weights`` takes a flax msgpack checkpoint (served at the operating
point its sidecar records, float32 with unfolded weights, as the JAX CLI
serves it) or a raw ultralytics state dict saved with ``torch.save``
(``.pt``).  ``convert-weights`` writes the msgpack layout, where the JAX
CLI writes an orbax directory: orbax imports JAX, which the port does not.
So ``--weights`` refuses an orbax directory, and a ``.safetensors`` file,
which the JAX CLI's ``torch.load`` cannot read either.
"""

from __future__ import annotations

import argparse
import os
import sys

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, PipelineVersion)

def common_flags(ap: argparse.ArgumentParser) -> None:
    """``--dataset`` and ``--device`` of the runners beside this CLI."""
    ap.add_argument("--dataset", default=os.environ.get("LIDAR_TPU_KITTI360"),
                    help="KITTI-360 root (default: $LIDAR_TPU_KITTI360)")
    ap.add_argument("--device", "--platform", dest="device", default="cuda",
                    help="cuda (default) or cpu")


def require_dataset(ap: argparse.ArgumentParser, args) -> None:
    """Refuse a run without data, or on a card that is not there."""
    if not args.dataset:
        ap.error("--dataset is required (or set LIDAR_TPU_KITTI360)")
    require_device(ap, args)


def require_device(ap: argparse.ArgumentParser, args) -> None:
    """Refuse a run on a card that is not there: no fallback to the CPU."""
    import torch

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        ap.error("--device cuda was asked for, but CUDA is not available; "
                 "pass --device cpu to run on the CPU")


# the versions whose run writes the master CSV (as the JAX CLI's)
CSV_VERSIONS = (PipelineVersion.CSV_EVAL, PipelineVersion.V2_STATS,
                PipelineVersion.V3_EROSION)


def _add_common(p, detector: bool = True) -> None:
    p.add_argument("--dataset", required=True,
                   help="KITTI-360 root (holds calibration/, data_3d_raw/, "
                        "data_2d_raw/, bboxes_3D_cam0/)")
    p.add_argument("--frames", type=int, nargs="*", default=None,
                   help="frame ids (default: all)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain twins)")
    if not detector:
        return
    p.add_argument("--detector", choices=["stub", "yolo"], default="stub",
                   help="stub = GT-derived synthetic detections; yolo = "
                        "YOLO11-seg (random weights without --weights)")
    p.add_argument("--weights", default=None,
                   help="yolo weights: a flax msgpack checkpoint "
                        "(checkpoints/yolo11*_seg_distill.msgpack, or "
                        "convert-weights' output) or a raw torch-saved "
                        "ultralytics state dict (.pt)")
    p.add_argument("--yolo-scale", default=None, choices=list("nsmlx"),
                   help="yolo scale (default: the checkpoint sidecar's "
                        "scale, else x)")
    p.add_argument("--conf", type=float, default=None,
                   help="yolo confidence threshold (default 0.25)")
    p.add_argument("--mask-thr", type=float, default=None,
                   help="mask binarization threshold (default: the "
                        "sidecar's, else 0.5)")
    p.add_argument("--mask-floor", type=float, default=None,
                   help="guarded shrink: fallback threshold for detections "
                        "that --mask-thr leaves near-empty")
    p.add_argument("--mask-min-pixels", type=int, default=None,
                   help="guarded shrink: pixel count under which a "
                        "detection falls back to --mask-floor")
    p.add_argument("--tta", default=None, choices=["none", "hflip"],
                   help="test-time augmentation (default: the sidecar's, "
                        "else none)")


def _refuse_weights(path: str) -> None:
    """Exit on the weight formats the port does not read, naming why."""
    if os.path.isdir(path):
        raise SystemExit(
            f"--weights {path!r} is a directory: an orbax checkpoint needs "
            "orbax.checkpoint, which imports JAX, and the port imports no "
            "JAX; convert the state dict with convert-weights (a .msgpack) "
            "instead")
    if path.endswith(".safetensors"):
        raise SystemExit(
            f"--weights {path!r}: a .safetensors file is not read, since "
            "the JAX CLI's loader is torch.load too and cannot read one "
            "either; save the state dict with torch.save (.pt)")


def _build_detector(args, dataset):
    """None for the stub; else a ``YoloDetector`` on ``args.device``."""
    if args.detector == "stub":
        return None
    from lidar_object_detection_tpu_torch.models.yolo.detector import (
        YoloDetector)
    from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)

    image_hw = (dataset.camera.height, dataset.camera.width)
    serving = dict(scale=args.yolo_scale, conf=args.conf,
                   mask_threshold=args.mask_thr,
                   mask_threshold_floor=args.mask_floor,
                   mask_min_pixels=args.mask_min_pixels, tta=args.tta)
    if args.weights and args.weights.endswith(".msgpack"):
        # float32, unfolded: the JAX CLI serves the raw variables
        det, _, _ = load_serving_checkpoint(
            args.weights, image_hw, default_scale="x", device=args.device,
            **serving)
        return det
    kw = {"mask_threshold": args.mask_thr or 0.5,
          "mask_threshold_floor": args.mask_floor,
          "mask_min_pixels": args.mask_min_pixels or 0,
          "tta": args.tta or "none", "device": args.device}
    if args.conf is not None:
        kw["conf"] = args.conf
    cfg = YoloConfig(scale=args.yolo_scale or "x")
    if args.weights:
        from lidar_object_detection_tpu_torch.models.yolo.weights import (
            convert_state_dict, flax_template, load_state_dict_file)

        _refuse_weights(args.weights)
        kw["variables"] = convert_state_dict(
            load_state_dict_file(args.weights), flax_template(cfg))
    return YoloDetector(image_hw, cfg, **kw)


def _convert_weights(args) -> int:
    """``convert-weights``: an ultralytics state dict -> a flax msgpack
    checkpoint ``{"variables": ...}`` and its sidecar ``{"scale": ...}``,
    which both CLIs' ``--weights`` serve."""
    import json

    from lidar_object_detection_tpu_torch.models.yolo.detector import (
        YoloDetector)
    from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig
    from lidar_object_detection_tpu_torch.models.yolo.weights import (
        convert_state_dict, flax_template, load_state_dict_file)
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        write_flax_msgpack)

    if not args.output.endswith(".msgpack"):
        raise SystemExit(f"--output {args.output!r} must be a .msgpack "
                         "path: --weights serves that suffix as a flax "
                         "msgpack checkpoint")
    cfg = YoloConfig(scale=args.scale)
    sd = load_state_dict_file(args.state_dict)
    variables = convert_state_dict(sd, flax_template(cfg))
    # the converted tree must load into the network, strictly
    YoloDetector(tuple(args.image_shape), cfg, variables=variables,
                 device="cpu")
    out_dir = os.path.dirname(os.path.abspath(args.output))
    os.makedirs(out_dir, exist_ok=True)
    write_flax_msgpack(args.output, {"variables": variables})
    with open(args.output + ".json", "w") as f:
        json.dump({"scale": args.scale}, f)
    print(f"converted {len(sd)} tensors -> {args.output}")
    return 0


def _export_yolo(args) -> int:
    """``yolo-export``: the JAX script's three refusals, then
    ``serving.export_serving_checkpoint`` and its lines."""
    if args.serving_tta is not None and args.serving_mask_thr is None:
        args.error("--serving-tta needs --serving-mask-thr (a serving block "
                   "is only written when a primary cut is recorded)")
    if args.serving_mask_floor is not None and args.serving_mask_thr is None:
        args.error("--serving-mask-floor needs --serving-mask-thr (the "
                   "floor is the fallback below a recorded primary cut)")
    if args.serving_mask_floor is not None \
            and not (args.serving_mask_min_pixels or 0) >= 1:
        args.error("--serving-mask-floor needs --serving-mask-min-pixels "
                   ">= 1 (with no pixel guard the floor can never fire)")
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        export_serving_checkpoint)

    serving = None
    if args.serving_mask_thr is not None:
        serving = {"mask_threshold": args.serving_mask_thr,
                   "mask_threshold_floor": args.serving_mask_floor,
                   "mask_min_pixels": args.serving_mask_min_pixels,
                   "tta": args.serving_tta}
    out = export_serving_checkpoint(args.src, args.dst, args.dtype, serving)
    for line in out["warnings"]:
        print(line)
    print(f"{args.src} -> {args.dst}: {out['bytes'] / 1e6:.1f} MB "
          f"(was {os.path.getsize(args.src) / 1e6:.1f}), "
          f"step {out['step']}, sidecar {out['sidecar']}")
    return 0


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="lidar_object_detection_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run a fusion pipeline version")
    _add_common(run_p)
    run_p.add_argument("--version", default="csv_eval",
                       choices=[v.value for v in PipelineVersion
                                if v not in (PipelineVersion.DEPTH_MAPS,
                                             PipelineVersion.KITTI2D_EVAL)])
    run_p.add_argument("--output", default="results",
                       help="output dir (master CSV, PLY exports)")
    run_p.add_argument("--export-ply", action="store_true",
                       help="write each frame's scene (points and matched "
                            "box wireframes) as frame_<id>.ply")
    run_p.add_argument("--analysis-cloud",
                       choices=["inside_outside", "car_color"], default=None,
                       help="write the V2 per-point bbox-analysis cloud "
                            "(green/red inside-outside labels, or the "
                            "reference's car colours) as analysis_<id>.ply")

    dm_p = sub.add_parser("depth-maps", help="per-car depth-map export")
    _add_common(dm_p)
    dm_p.add_argument("--output", default="Predictions")

    es_p = sub.add_parser("erosion-study",
                          help="erosion vs no-erosion comparison (the "
                               "reference's results workbook)")
    _add_common(es_p)
    es_p.add_argument("--output", default="results")

    pt_p = sub.add_parser(
        "pointpillars-train",
        help="train the pure-LiDAR PointPillars on a drive's frames; "
             "--checkpoint-dir receives pp_<head>_step<N>.msgpack (flax "
             "msgpack of (variables, opt_state, step) and a .json "
             "sidecar) where the JAX CLI writes an orbax directory, since "
             "orbax imports JAX")
    _add_common(pt_p, detector=False)
    pt_p.add_argument("--steps", type=int, default=50)
    pt_p.add_argument("--checkpoint-dir", default=None,
                      help="directory for pp_<head>_step<N>.msgpack, which "
                           "both packages' pointpillars-infer --ckpt read")
    pt_p.add_argument("--surround", action="store_true",
                      help="360-degree KITTI-360 grid "
                           "(PillarsConfig.kitti360_surround)")
    pt_p.add_argument("--aggregate-sweeps", action="store_true",
                      help="train on pose-aggregated multi-sweep clouds "
                           "(data/poses.py)")
    pt_p.add_argument("--max-points", type=int, default=None,
                      help="subsample training clouds to this many points")
    pt_p.add_argument("--head", default="ssd", choices=("ssd", "center"),
                      help="detection head family: anchor-based SSD or the "
                           "CenterPoint heatmap head (NMS-free decode)")

    pi_p = sub.add_parser("pointpillars-infer",
                          help="run a trained PointPillars checkpoint over "
                               "dataset frames (detections JSON + optional "
                               "PLY scenes)")
    _add_common(pi_p, detector=False)
    pi_p.add_argument("--ckpt", required=True,
                      help="checkpoint from the surround training runner "
                           "(flax msgpack of (variables, opt_state, step))")
    pi_p.add_argument("--output", default="pp_detections")
    pi_p.add_argument("--surround", action="store_true")
    pi_p.add_argument("--aggregate-sweeps", action="store_true")
    pi_p.add_argument("--head", default="ssd", choices=("ssd", "center"))
    pi_p.add_argument("--score-threshold", type=float, default=0.3)
    pi_p.add_argument("--max-points", type=int, default=None)
    pi_p.add_argument("--export-ply", action="store_true")

    pe_p = sub.add_parser("pointpillars-export",
                          help="slim a full PointPillars checkpoint to its "
                               "variables and step (sidecar copied)")
    pe_p.add_argument("src")
    pe_p.add_argument("dst")

    ye_p = sub.add_parser("yolo-export",
                          help="slim a YOLO distillation run to a serving "
                               "checkpoint (EMA variables preferred, float "
                               "arrays cast) with its sidecar serving block")
    ye_p.add_argument("src")
    ye_p.add_argument("dst")
    ye_p.add_argument("--dtype", default="bfloat16",
                      help="storage dtype for float arrays "
                           "(bfloat16/float32)")
    ye_p.add_argument("--serving-mask-thr", type=float, default=None,
                      help="record this mask threshold in the exported "
                           "sidecar's serving block (the CLI and "
                           "regen_artifacts serve it by default); omitted = "
                           "keep the source sidecar's serving block if any")
    ye_p.add_argument("--serving-mask-floor", type=float, default=None,
                      help="record a guarded-shrink floor threshold in the "
                           "serving block (with --serving-mask-min-pixels)")
    ye_p.add_argument("--serving-mask-min-pixels", type=int, default=None,
                      help="record the guarded-shrink pixel guard in the "
                           "serving block")
    ye_p.add_argument("--serving-tta", default=None,
                      choices=["none", "hflip"],
                      help="record a test-time-augmentation mode in the "
                           "serving block (models/yolo/tta.py)")
    ye_p.set_defaults(error=ye_p.error)

    cw_p = sub.add_parser("convert-weights",
                          help="torch state dict -> flax msgpack checkpoint "
                               "of YOLO11(-seg)")
    cw_p.add_argument("--state-dict", required=True,
                      help="torch-saved raw state dict (.pt)")
    cw_p.add_argument("--output", required=True,
                      help="msgpack checkpoint path (.msgpack), with a "
                           "sidecar <output>.json recording the scale")
    cw_p.add_argument("--scale", default="x", choices=list("nsmlx"))
    cw_p.add_argument("--image-shape", type=int, nargs=2, default=(376, 1408),
                      help="(H, W) of a detector the converted weights are "
                           "loaded into as a check")

    k2_p = sub.add_parser("kitti2d", help="KITTI 2D detection eval")
    k2_p.add_argument("--dataset", required=True,
                      help="KITTI_Selection root (images/ labels/ calib/)")
    k2_p.add_argument("--output", default="results")
    k2_p.add_argument("--conf", type=float, default=0.5)
    k2_p.add_argument("--device", default="cuda",
                      help="torch device to run on (default cuda; cpu runs "
                           "the plain twins)")
    return parser


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.cmd == "convert-weights":
        return _convert_weights(args)

    if args.cmd == "pointpillars-export":
        from lidar_object_detection_tpu_torch.pipelines.pointpillars import (
            export_slim_checkpoint)
        out = export_slim_checkpoint(args.src, args.dst)
        print(f"{args.src} -> {args.dst}: {out['bytes'] / 1e6:.1f} MB "
              f"(was {os.path.getsize(args.src) / 1e6:.1f}), step "
              f"{out['step']}, sidecar {out['sidecar']}")
        return 0

    if args.cmd == "yolo-export":
        return _export_yolo(args)

    if args.cmd == "kitti2d":
        from lidar_object_detection_tpu_torch.pipelines.kitti2d import (
            run_kitti2d_eval)
        result = run_kitti2d_eval(args.dataset, output_dir=args.output,
                                  conf=args.conf, device=args.device)
        t = result.totals
        print(f"TP: {t['tp']}  FP: {t['fp']}  FN: {t['fn']}")
        print(f"Precision: {t['precision']:.2f}  Recall: {t['recall']:.2f}")
        return 0

    if args.cmd == "pointpillars-train":
        from lidar_object_detection_tpu_torch.pipelines.pointpillars import (
            train_pointpillars)
        out = train_pointpillars(args.dataset, steps=args.steps,
                                 frame_ids=args.frames,
                                 checkpoint_dir=args.checkpoint_dir,
                                 surround=args.surround,
                                 aggregate=args.aggregate_sweeps,
                                 max_points=args.max_points,
                                 head=args.head, device=args.device)
        evals = out["eval"]
        last = (f"{out['loss_history'][-1]:.4f}" if out["loss_history"]
                else "n/a (0 steps)")
        print(f"final loss: {last}; eval "
              f"recall={sum(e.matched for e in evals)}/"
              f"{sum(e.total_gt for e in evals)}")
        return 0

    if args.cmd == "pointpillars-infer":
        from lidar_object_detection_tpu_torch.pipelines.pointpillars import (
            infer_pointpillars)
        dets = infer_pointpillars(
            args.dataset, args.ckpt, frame_ids=args.frames,
            surround=args.surround, aggregate=args.aggregate_sweeps,
            head=args.head, max_points=args.max_points,
            score_threshold=args.score_threshold, output_dir=args.output,
            export_ply=args.export_ply, device=args.device)
        total = sum(len(d["boxes7"]) for d in dets)
        print(f"{len(dets)} frames, {total} detections -> {args.output}")
        return 0

    from lidar_object_detection_tpu_torch.data.kitti360 import (
        Kitti360Dataset)

    if args.cmd == "erosion-study":
        from lidar_object_detection_tpu_torch.eval.erosion_study import (
            run_erosion_study)
        os.makedirs(args.output, exist_ok=True)
        ds = Kitti360Dataset(args.dataset)
        res = run_erosion_study(
            args.dataset, frame_ids=args.frames,
            detector=_build_detector(args, ds),
            output_csv=os.path.join(args.output, "erosion_study.csv"),
            output_xlsx=os.path.join(args.output,
                                     "master_car_statistics.csv.xlsx"),
            device=args.device)
        print("erosion study:", res.summary())
        return 0

    from lidar_object_detection_tpu_torch.pipelines.runner import (
        FusionPipeline)

    if args.cmd == "depth-maps":
        import numpy as np

        from lidar_object_detection_tpu_torch.viz.overlay import (
            depth_map_figure)

        cfg = FusionConfig.for_version(PipelineVersion.DEPTH_MAPS)
        ds = Kitti360Dataset(args.dataset, shapes=cfg.shapes)
        pipe = FusionPipeline(ds, cfg, _build_detector(args, ds),
                              device=args.device)
        os.makedirs(args.output, exist_ok=True)
        count = 0
        for frame_id, car_id, dm, seg in pipe.depth_maps(args.frames):
            path = os.path.join(
                args.output,
                f"{frame_id:010d},depth_map_car_{car_id:02d}_.png")
            if seg is None:
                seg = np.zeros((*dm.shape, 3), np.uint8)
            depth_map_figure(dm, seg, car_id, frame_id, path)
            count += 1
        print(f"wrote {count} depth maps to {args.output}")
        return 0

    # cmd == run
    version = PipelineVersion(args.version)
    from lidar_object_detection_tpu_torch.eval.statistics import (
        analyze_master_csv)

    cfg = FusionConfig.for_version(version)
    ds = Kitti360Dataset(args.dataset, shapes=cfg.shapes)
    pipe = FusionPipeline(ds, cfg, _build_detector(args, ds),
                          device=args.device)
    os.makedirs(args.output, exist_ok=True)
    master_csv = (os.path.join(args.output, "master_car_statistics.csv")
                  if version in CSV_VERSIONS else None)
    result = pipe.run(args.frames, master_csv=master_csv)

    print(f"processed {len(result.frames)} frames in {result.elapsed_s:.3f}s "
          f"({result.frames_per_s:.1f} frames/s) on {pipe.device}")
    s = result.summary()
    print(f"cars: {s['total_cars']}  matched: {s['matched']}  "
          f"avg inside%: {s['avg_inside_pct']:.2f}")
    for fr in result.frames:
        n_matched = sum(1 for p in fr.matched_pairs
                        if not p.get("unmatched"))
        print(f"frame {fr.frame_id}: {fr.num_detections} detections, "
              f"{fr.num_visible_boxes} visible boxes, {n_matched} matched")
    if master_csv:
        print("analysis:", analyze_master_csv(master_csv))
    if args.export_ply:
        from lidar_object_detection_tpu_torch.viz.export import (
            export_fusion_scene)
        records = ds.load_frames(args.frames)
        for fr, rec in zip(result.frames, records):
            path = os.path.join(args.output, f"frame_{fr.frame_id:010d}.ply")
            export_fusion_scene(path, rec.points[:, :3], None,
                                fr.matched_pairs)
        print(f"PLY scenes written to {args.output}")
    if args.analysis_cloud:
        from lidar_object_detection_tpu_torch.viz.export import write_ply
        clouds = pipe.analysis_clouds(
            [fr.frame_id for fr in result.frames], mode=args.analysis_cloud,
            detections=result.detections)
        for frame_id, pts, colors, _ in clouds:
            write_ply(os.path.join(args.output,
                                   f"analysis_{frame_id:010d}.ply"),
                      pts, colors)
        print(f"analysis clouds written to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
