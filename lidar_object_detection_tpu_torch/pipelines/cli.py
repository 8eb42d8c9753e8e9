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

Counterpart of ``lidar_object_detection_tpu/pipelines/cli.py`` for the
``run`` (every version, with ``--export-ply`` and ``--analysis-cloud``),
``erosion-study`` and ``depth-maps`` subcommands.  ``--device`` (default
``cuda``) takes the place of the JAX CLI's ``--platform``; ``--device
cpu`` runs the plain twins on the CPU.  The YOLO detector serves a msgpack
checkpoint in float32 with unfolded weights, at the operating point its
sidecar records, as the JAX CLI does.

The other subcommands and weight formats of the JAX CLI are not ported
yet: they exit non-zero with a message naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, PipelineVersion)

# subcommand -> the ROADMAP Queue 1 item that ports it
UNPORTED_COMMANDS = {
    "kitti2d": 6,
    "convert-weights": 6,
    "pointpillars-train": 8,
    "pointpillars-infer": 8,
}
# the versions whose run writes the master CSV (as the JAX CLI's)
CSV_VERSIONS = (PipelineVersion.CSV_EVAL, PipelineVersion.V2_STATS,
                PipelineVersion.V3_EROSION)


def _not_ported(what: str, item: int) -> SystemExit:
    return SystemExit(f"{what} is not ported yet (ROADMAP Queue 1 item "
                      f"{item})")


def _add_common(p) -> None:
    p.add_argument("--dataset", required=True,
                   help="KITTI-360 root (holds calibration/, data_3d_raw/, "
                        "data_2d_raw/, bboxes_3D_cam0/)")
    p.add_argument("--frames", type=int, nargs="*", default=None,
                   help="frame ids (default: all)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain twins)")
    p.add_argument("--detector", choices=["stub", "yolo"], default="stub",
                   help="stub = GT-derived synthetic detections; yolo = "
                        "YOLO11-seg (random weights without --weights)")
    p.add_argument("--weights", default=None,
                   help="yolo weights: a flax msgpack checkpoint "
                        "(checkpoints/yolo11*_seg_distill.msgpack)")
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
    if args.weights:
        if not args.weights.endswith(".msgpack"):
            raise _not_ported(f"weights {args.weights!r} (orbax or "
                              "state-dict formats)", 6)
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
    return YoloDetector(image_hw, YoloConfig(scale=args.yolo_scale or "x"),
                        **kw)


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

    for name, item in UNPORTED_COMMANDS.items():
        sub.add_parser(name, help=f"not ported yet (ROADMAP Queue 1 item "
                                  f"{item})")
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd in UNPORTED_COMMANDS:
        raise _not_ported(f"the {args.cmd} subcommand",
                          UNPORTED_COMMANDS[args.cmd])
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")

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
