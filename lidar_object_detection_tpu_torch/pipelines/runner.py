"""The fusion pipeline runner: the entry points of the reference scripts.

Counterpart of ``lidar_object_detection_tpu/pipelines/runner.py``: V1-V3
and csv_eval (``cvs_erosion.py``, point-count matching, with or without
erosion), V4 (greedy 2D IoU) and V5 (Hungarian), and the export paths.  A
run loads a KITTI-360 directory (``data/``), detects (the stub by default,
or ``YoloDetector``: kernels K5, K3 and K2 on the card), fuses on the
device (``fusion/associate.py``: kernel K1 on the card), matches (V4, or
V5 with the ``lap`` kernel on the card), and formats the per-car rows on
the host, appending them to the master CSV.  ``FusionPipeline.stream``
runs a whole sequence in fixed-size chunks: the native prefetcher
(``data/native.py``) reads and, by default, culls the scans to the camera
frustum, and a producer thread reads boxes and decodes PNGs one chunk
ahead of the card.

The exports run on the device a batch at a time: ``depth_maps``
(seg_with_pointcloud.py; a scatter-max per detection, ``ops/scatter.py``)
and ``analysis_clouds`` (the V2 per-point bbox-analysis cloud).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, FusionParams, MatchStrategy, PipelineVersion)
from lidar_object_detection_tpu_torch.data.kitti360 import (
    FrameBatch, FrameRecord, Kitti360Dataset)
from lidar_object_detection_tpu_torch.data.native import (
    CompactionSpec, ScanPrefetcher)
from lidar_object_detection_tpu_torch.eval import statistics as stats_lib
from lidar_object_detection_tpu_torch.fusion.associate import (
    fuse_batch, greedy_iou_match, hungarian_match, point_inside_labels)
from lidar_object_detection_tpu_torch.geom.boxes import transform_corners
from lidar_object_detection_tpu_torch.models.stub import StubDetector
from lidar_object_detection_tpu_torch.ops import masks as masks_lib
from lidar_object_detection_tpu_torch.ops.scatter import scatter_depth_maps
from lidar_object_detection_tpu_torch.utils import h2d, profiling
from lidar_object_detection_tpu_torch.viz.overlay import (
    analysis_cloud_colors, overlay_masks)


@dataclasses.dataclass
class FrameResult:
    frame_id: int
    statistics: List[stats_lib.CarStatistics]
    # {detection, box_index, corners_velo, ...}; V5 appends its unmatched
    # boxes (detection -1, "unmatched", a grey "color")
    matched_pairs: List[dict]
    num_detections: int
    num_visible_boxes: int


@dataclasses.dataclass
class RunResult:
    """``frames_per_s`` is end to end: detection (when this run performed
    it) + fusion + matching.  ``fusion_frames_per_s`` covers only the
    fusion and matching; ``detect_s`` is 0.0 when the caller passed the
    detections.  ``detections`` are those the run fused, on the
    pipeline's device (the exports reuse them)."""

    frames: List[FrameResult]
    csv_rows: List[stats_lib.CarStatistics]
    elapsed_s: float            # detect_s + fusion and matching time
    frames_per_s: float         # end to end (same window as elapsed_s)
    detect_s: float = 0.0
    fusion_frames_per_s: float = 0.0
    detections: Optional[Dict[str, torch.Tensor]] = None

    def summary(self) -> dict:
        return stats_lib.summarize(self.csv_rows)


class FusionPipeline:
    """Dataset -> detector -> fusion on ``device`` -> rows.

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to run the plain twins on the CPU.  A ``YoloDetector``
    passed in must live on the same device.

    On the card the copies to it go through the pinned ring of
    ``utils.h2d``, and :meth:`detect` sends its batch's scans, validity
    and boxes ahead while the detector runs; the :meth:`fuse` of that very
    batch object takes them, once.  From ``detect`` until then the batch's
    arrays are read in the background: leave them as they are.
    """

    def __init__(self, dataset: Kitti360Dataset, config: FusionConfig,
                 detector=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        self.dataset = dataset
        self.config = config
        self.params = FusionParams.from_config(config)
        t = dataset.transforms
        self.detector = detector or StubDetector(
            dataset.camera, max_detections=config.shapes.max_detections,
            depth_range=(0.0, config.depth_max),
            corners_to_cam=t.corners_cam0_to_cam)
        as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                           device=self.device)
        self._velo_to_rect = as_dev(t.velo_to_rect)
        # GT corners are annotated in cam0; for cam k > 0 they move into the
        # rectified cam-k frame before projection, and corners_to_velo
        # composes back through cam0_to_velo (calib.TransformChain)
        self._corners_to_cam = (None if dataset.camera.cam_id == 0
                                else as_dev(t.corners_cam0_to_cam))
        self._corners_to_velo = as_dev(t.corners_to_velo)
        self._intrinsics = as_dev(dataset.camera.intrinsics)
        # (batch, h2d.Handle) of the scans that the last detect sent ahead
        self._ahead = None

    def _gt_corners(self, batch: FrameBatch,
                    corners: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Batch GT corners in the configured camera's projection frame,
        from ``corners``, the batch's cam0 corners on the device, when
        given."""
        if corners is None:
            corners, = h2d.upload([batch.corners_cam0], self.device)
        if self._corners_to_cam is not None:
            corners = transform_corners(corners, self._corners_to_cam)
        return corners

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def detect(self, records, batch: FrameBatch,
               images: Optional[np.ndarray] = None
               ) -> Dict[str, torch.Tensor]:
        """Run the detector: the stub reads the frame records, a
        ``YoloDetector`` the batch's images, decoded here unless the caller
        (the streaming path) passes them decoded.  Returns tensors on the
        pipeline's device.  On the card the batch's scans are sent ahead
        (see the class).  Each call begins a chunk of the spans
        (``utils.profiling``)."""
        profiling.new_chunk()
        with profiling.span("detect", self.device):
            ahead = self._send_ahead(batch)
            self._ahead = None if ahead is None else (batch, ahead)
            try:
                if isinstance(self.detector, StubDetector):
                    out = self.detector.detect_records(records)
                else:
                    if images is None:
                        images = self.dataset.load_images(batch)
                    out = self.detector.detect(images)
                return dict(zip(out, h2d.upload(list(out.values()),
                                                self.device)))
            finally:
                if ahead is not None:
                    ahead.release()

    @staticmethod
    def _scan_arrays(batch: FrameBatch) -> list:
        return [batch.points, batch.point_valid, batch.corners_cam0,
                batch.box_valid]

    def _send_ahead(self, batch: FrameBatch) -> Optional[h2d.Handle]:
        """On the card: hand the batch's scan arrays to the uploader, to
        be copied behind the frames while the detector runs."""
        if self.device.type != "cuda":
            return None
        arrays = self._scan_arrays(batch)
        with profiling.span("detect.prefetch", self.device,
                            nbytes=sum(a.nbytes for a in arrays)):
            return h2d.uploader(self.device).submit(arrays, after_next=True)

    def fuse(self, batch: FrameBatch, detections: Dict[str, torch.Tensor]):
        """Fuse the batch's scans and boxes with its detections on the
        device (``fusion.associate.fuse_batch``); the spans share the
        chunk of the last :meth:`detect`.  The scans that ``detect`` sent
        ahead for this very ``batch`` are taken, once; any other call
        copies them itself (``fuse.upload`` counts the bytes it copied)."""
        d = self.device
        ahead, self._ahead = self._ahead, None
        hit = ahead is not None and ahead[0] is batch
        arrays = self._scan_arrays(batch)
        with profiling.span("fuse", d):
            with profiling.span("fuse.upload", d, nbytes=0 if hit else sum(
                    a.nbytes for a in arrays)):
                points, point_valid, corners, box_valid = (
                    ahead[1].result() if hit else h2d.upload(arrays, d))
                corners = self._gt_corners(batch, corners)
            return fuse_batch(
                points, point_valid,
                torch.as_tensor(detections["mask_bits"]).to(d),
                torch.as_tensor(detections["det_valid"]).to(d),
                corners, box_valid, self._velo_to_rect,
                self._corners_to_velo, self._intrinsics, self.params)

    # ------------------------------------------------------------------
    def run(self, frame_ids: Optional[Sequence[int]] = None,
            master_csv: Optional[str] = None,
            detections: Optional[Dict[str, torch.Tensor]] = None,
            timestamp: Optional[str] = None) -> RunResult:
        """Detect (unless ``detections`` are given), fuse and format the
        frames; append each frame's rows to ``master_csv`` when given, with
        ``timestamp`` (default: the time of each write)."""
        records = self.dataset.load_frames(frame_ids)
        if not records:
            return RunResult([], [], 0.0, 0.0)
        batch = self.dataset.make_batch(records)
        detect_s = 0.0
        if detections is None:
            td = time.perf_counter()
            detections = self.detect(records, batch)
            self._sync()
            detect_s = time.perf_counter() - td

        t0 = time.perf_counter()
        detections = {k: torch.as_tensor(v).to(self.device)
                      for k, v in detections.items()}
        fused = self.fuse(batch, detections)
        match_idx, match_aux = self.match(batch, detections, fused)
        self._sync()
        elapsed = time.perf_counter() - t0

        fused_np = {k: fused[k].cpu().numpy() for k in (
            "total_points", "best_box", "points_inside", "matched",
            "box_visible", "corners_velo")}
        match_idx = match_idx.cpu().numpy()
        match_aux = {k: v.cpu().numpy() for k, v in match_aux.items()}
        det_valid = detections["det_valid"].cpu().numpy()
        frames: List[FrameResult] = []
        all_rows: List[stats_lib.CarStatistics] = []
        for i, rec in enumerate(records):
            rows = stats_lib.frame_statistics(
                rec.frame_id, fused_np["total_points"][i],
                fused_np["best_box"][i], fused_np["points_inside"][i],
                fused_np["matched"][i], det_valid[i],
                fused_np["box_visible"][i])
            frames.append(FrameResult(
                frame_id=rec.frame_id, statistics=rows,
                matched_pairs=self._matched_pairs(
                    i, det_valid, match_idx, match_aux, fused_np),
                num_detections=int(det_valid[i].sum()),
                num_visible_boxes=int(fused_np["box_visible"][i].sum())))
            all_rows.extend(rows)
            if master_csv:
                stats_lib.append_to_master_csv(rows, master_csv, timestamp)
        total = elapsed + detect_s
        fps = len(records) / total if total > 0 else 0.0
        fusion_fps = len(records) / elapsed if elapsed > 0 else 0.0
        return RunResult(frames=frames, csv_rows=all_rows,
                         elapsed_s=total, frames_per_s=fps,
                         detect_s=detect_s, fusion_frames_per_s=fusion_fps,
                         detections=detections)

    def match(self, batch: FrameBatch, detections: Dict[str, torch.Tensor],
              fused: Dict[str, torch.Tensor]):
        """Each detection's GT box under the configured strategy: the
        fusion's best box (point count), the greedy 2D IoU against the
        visible boxes (V4), or the Hungarian assignment against every real
        box (V5, which skips the visibility filter).  Returns (match_idx
        (B, D) int32, -1 unmatched, and the per-pair values: V4 ``iou``,
        V5 ``score`` and ``iou``)."""
        c = self.config
        if c.match_strategy == MatchStrategy.POINT_COUNT:
            return fused["best_box"], {}
        boxes = detections["boxes"].to(torch.float32)
        corners = self._gt_corners(batch)
        if c.match_strategy == MatchStrategy.GREEDY_IOU:
            idx, iou = greedy_iou_match(
                boxes, detections["det_valid"], corners,
                fused["box_visible"], self._intrinsics, c.greedy_min_iou)
            return idx, {"iou": iou}
        idx, score, iou = hungarian_match(
            boxes, detections["det_valid"], corners,
            h2d.upload([batch.box_valid], self.device)[0],
            self._intrinsics, c.hungarian_min_score, c.hungarian_min_iou,
            c.score_weight_iou, c.score_weight_center, c.score_weight_size,
            c.center_norm)
        return idx, {"score": score, "iou": iou}

    def _matched_pairs(self, i, det_valid, match_idx, match_aux,
                       fused_np) -> List[dict]:
        """Each matched detection of frame ``i`` with its box, for
        wireframe rendering (V1:400-405, V4:177-182, V5:553-556); V5 adds
        every unmatched box in light grey (V5:408-414)."""
        pairs = []
        corners_velo = fused_np["corners_velo"][i]
        for det in range(self.config.shapes.max_detections):
            box = int(match_idx[i][det])
            if not det_valid[i][det] or box < 0:
                continue
            pair = {"detection": det, "box_index": box,
                    "corners_velo": corners_velo[box]}
            for k, v in match_aux.items():
                pair[k] = float(v[i][det])
            if self.config.match_strategy == MatchStrategy.POINT_COUNT:
                pair["point_count"] = int(fused_np["points_inside"][i][det])
            pairs.append(pair)
        if self.config.match_strategy == MatchStrategy.HUNGARIAN:
            matched_boxes = {p["box_index"] for p in pairs}
            box_valid = fused_np["box_visible"][i]
            for g in range(box_valid.shape[0]):
                if box_valid[g] and g not in matched_boxes:
                    pairs.append({"detection": -1, "box_index": g,
                                  "corners_velo": corners_velo[g],
                                  "unmatched": True,
                                  "color": (0.7, 0.7, 0.7)})
        return pairs

    # ------------------------------------------------------------------
    def compaction_spec(self) -> CompactionSpec:
        """The host cull matching this pipeline's device validity test
        (:class:`~lidar_object_detection_tpu_torch.data.native.CompactionSpec`):
        points outside the camera frustum or depth range are dropped in
        the loader threads, and the device's exact test masks the
        conservative leftovers, so the fusion's outputs are unchanged.  The
        capacity is half of ``max_points``, rounded down to a multiple of
        4096 (at least 4096), as in the JAX package."""
        s = self.config.shapes
        max_out = max(4096, (s.max_points // 2 // 4096) * 4096)
        return CompactionSpec.build(
            self.dataset.transforms.velo_to_rect,
            self.dataset.camera.intrinsics, s.image_width, s.image_height,
            self.config.depth_min, self.config.depth_max, max_out)

    def stream(self, frame_ids: Optional[Sequence[int]] = None,
               chunk: int = 8, store=None, compact: bool = True,
               num_threads: int = 2, timestamp: Optional[str] = None):
        """Streaming fusion over a whole sequence, in chunks of ``chunk``
        frames.

        The native prefetcher's threads read the scans ahead of the card
        (``data/native.py``), and its buffers feed the device as they are:
        scans are never read again.  With ``compact=True`` the threads also
        cull each scan to the camera frustum, into half the padded size
        (:meth:`compaction_spec`); a scan with more points than that inside
        raises.  A producer thread reads the boxes and decodes the PNGs one
        chunk ahead; it does no work on the card.  An error there reaches
        the caller as the exception it is, never as a short stream.  Rows
        go into ``store`` (a :class:`~..eval.store.MetricStore`) when given,
        with ``timestamp`` (default: the time of each write).

        Frames come in the prefetcher's completion order.  Yields
        ``(frame_id, rows)`` per processed frame.
        """
        ids = list(frame_ids) if frame_ids is not None \
            else self.dataset.frame_ids()
        # only frames with boxes (the reference's skip rule); a frame whose
        # box list turns out empty is skipped again after load_boxes
        ids = [f for f in ids if self.dataset.load_bboxes_exists(f)]
        s = self.config.shapes
        paths = [self.dataset.scan_path(f) for f in ids]
        spec = self.compaction_spec() if compact else None
        pre = iter(ScanPrefetcher(paths, s.max_points,
                                  num_threads=num_threads,
                                  queue_depth=2 * chunk, compaction=spec))
        stub = isinstance(self.detector, StubDetector)

        def chunks():
            pending = []
            done = False
            while not done:
                while len(pending) < chunk:
                    try:
                        idx, pts, valid, n = next(pre)
                    except StopIteration:
                        done = True
                        break
                    pending.append((ids[idx], pts, valid, n))
                if not pending:
                    break
                keep = []
                for fid, pts, valid, n in pending[:chunk]:
                    corners = self.dataset.load_boxes(fid)
                    if corners is None:
                        continue
                    keep.append((fid, pts, valid, n, corners))
                del pending[:chunk]
                if not keep:
                    continue
                batch = self._assemble_stream_batch(keep)
                records = [FrameRecord(frame_id=fid, points=pts[:n],
                                       corners_cam0=corners,
                                       image_path=self.dataset.image_path(fid))
                           for fid, pts, _, n, corners in keep]
                images = None if stub else self.dataset.load_images(batch)
                yield keep, batch, records, images

        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put_checked(msg) -> bool:
            """A bounded put that gives up once the consumer is gone, so an
            abandoned generator never wedges the producer (and with it the
            prefetcher's buffers) on a full queue."""
            while not stop.is_set():
                try:
                    q.put(msg, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in chunks():
                    if not put_checked(("item", item)):
                        return
                put_checked(("done", None))
            except BaseException as exc:  # noqa: BLE001 -- raised below
                put_checked(("error", exc))

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                kind, item = q.get()
                if kind == "done":
                    break
                if kind == "error":
                    raise item
                keep, batch, records, images = item
                detections = self.detect(records, batch, images=images)
                fused = self.fuse(batch, detections)
                fused_np = {k: fused[k].cpu().numpy() for k in (
                    "total_points", "best_box", "points_inside", "matched",
                    "box_visible")}
                det_valid = detections["det_valid"].cpu().numpy()
                for i, (fid, *_rest) in enumerate(keep):
                    rows = stats_lib.frame_statistics(
                        fid, fused_np["total_points"][i],
                        fused_np["best_box"][i], fused_np["points_inside"][i],
                        fused_np["matched"][i], det_valid[i],
                        fused_np["box_visible"][i])
                    if store is not None:
                        store.update_frame(fid, rows, timestamp)
                    yield fid, rows
        finally:
            stop.set()
            try:                      # unblock a producer mid-put
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def _assemble_stream_batch(self, keep) -> FrameBatch:
        """A fixed-shape batch straight from the prefetcher's buffers: the
        point arrays are stacked as delivered (the loader padded them), and
        only the corners are padded to ``max_boxes``."""
        s = self.config.shapes
        b = len(keep)
        corners = np.zeros((b, s.max_boxes, 8, 3), np.float32)
        box_valid = np.zeros((b, s.max_boxes), bool)
        for i, (_, _, _, _, c) in enumerate(keep):
            g = c.shape[0]
            if g > s.max_boxes:
                raise ValueError(f"{g} boxes exceed max_boxes={s.max_boxes}")
            corners[i, :g] = c.astype(np.float32)
            box_valid[i, :g] = True
        return FrameBatch(
            frame_ids=np.asarray([k[0] for k in keep], np.int32),
            points=np.stack([k[1] for k in keep]),
            point_valid=np.stack([k[2] for k in keep]),
            corners_cam0=corners, box_valid=box_valid,
            image_paths=[self.dataset.image_path(k[0]) for k in keep])

    # ------------------------------------------------------------------
    def _detections_for(self, records, batch: FrameBatch, detections,
                        lo: int = 0) -> Dict[str, torch.Tensor]:
        """The batch's detections on the device: frames ``lo`` onward of
        the given ``detections``, or the detector's."""
        if detections is None:
            return self.detect(records, batch)
        n = len(records)
        return {k: torch.as_tensor(v)[lo:lo + n].to(self.device)
                for k, v in detections.items()}

    def analysis_clouds(self, frame_ids: Optional[Sequence[int]] = None,
                        mode: str = "inside_outside",
                        detections: Optional[Dict[str, torch.Tensor]] = None
                        ) -> List[tuple]:
        """The V2 per-point bbox-analysis cloud of each frame
        (V2_point_cloud_without_erosion.py:446-491): each matched car's
        points labelled inside or outside its matched GT box (point-count
        match), on the device, one batch for all frames.  ``detections``
        (e.g. a run's) skip the detector; they must cover the frames.

        Returns a list of (frame_id, points (N, 3), colours (N, 3) in
        [0, 1], matched corners list) over each frame's real points.
        """
        records = self.dataset.load_frames(frame_ids)
        if not records:
            return []
        batch = self.dataset.make_batch(records)
        dets = self._detections_for(records, batch, detections)
        fused = self.fuse(batch, dets)
        d = self.config.shapes.max_detections
        inside = point_inside_labels(
            h2d.upload([batch.points], self.device)[0],
            fused["point_bits"], fused["corners_velo"], fused["best_box"],
            fused["matched"], d)
        bits = fused["point_bits"].cpu().numpy()
        inside = inside.cpu().numpy()
        best_box = fused["best_box"].cpu().numpy()
        matched = fused["matched"].cpu().numpy()
        corners_velo = fused["corners_velo"].cpu().numpy()
        out = []
        for i, rec in enumerate(records):
            valid = batch.point_valid[i]       # real (non-pad) points
            colors = analysis_cloud_colors(bits[i][valid], inside[i][valid],
                                           d, mode=mode)
            corners = [corners_velo[i][int(b)]
                       for b, m in zip(best_box[i], matched[i]) if m]
            out.append((rec.frame_id, batch.points[i][valid][:, :3], colors,
                        corners))
        return out

    def analysis_cloud(self, frame_id: int, mode: str = "inside_outside"):
        """One frame's analysis cloud: (points, colours, matched corners),
        as the JAX package's ``analysis_cloud`` returns it."""
        clouds = self.analysis_clouds([frame_id], mode)
        if not clouds:
            raise ValueError(f"frame {frame_id} not loadable")
        return clouds[0][1:]

    def depth_maps(self, frame_ids: Optional[Sequence[int]] = None,
                   with_seg_images: bool = True,
                   detections: Optional[Dict[str, torch.Tensor]] = None,
                   chunk: int = 8):
        """Per-car depth maps (seg_with_pointcloud.py:160-170), on the
        device, ``chunk`` frames at a time (each frame's maps take D x H x
        W float32, 68 MB at full size).

        Yields (frame_id, car_id, depth_map (H, W) float32, seg_image) for
        each valid detection with points, car ids from 1.  ``seg_image``
        is the frame with the detection masks blended over it (the
        reference draws the depth over the segmented image, :173-194);
        with ``with_seg_images=False`` it is None and no image is read.
        ``detections`` (e.g. a run's) skip the detector; they must cover
        the frames.
        """
        records = self.dataset.load_frames(frame_ids)
        s = self.config.shapes
        d = s.max_detections
        for lo in range(0, len(records), chunk):
            part = records[lo:lo + chunk]
            batch = self.dataset.make_batch(part)
            dets = self._detections_for(part, batch, detections, lo)
            fused = self.fuse(batch, dets)
            maps = scatter_depth_maps(
                fused["u"], fused["v"], fused["depth"],
                masks_lib.unpack_point_bits(fused["point_bits"], d),
                fused["point_valid"], s.image_height, s.image_width)
            # the reference skips empty maps (:174-175)
            keep = dets["det_valid"] & (maps.amax(dim=(-2, -1)) > 0)
            kept = keep.nonzero().cpu().tolist()
            kept_maps = maps[keep].cpu().numpy()
            del maps
            images = self.dataset.load_images(batch) if with_seg_images \
                else None
            mask_bits = dets["mask_bits"].cpu()
            det_valid = dets["det_valid"].cpu().numpy()
            seg = {}
            for (i, det), dm in zip(kept, kept_maps):
                if images is not None and i not in seg:
                    masks = masks_lib.unpack_masks(mask_bits[i], d).numpy()
                    seg[i] = overlay_masks(images[i], masks[det_valid[i]])
                yield part[i].frame_id, det + 1, dm, seg.get(i)

# ---------------------------------------------------------------------------
# Version entry points (reference script equivalents)
# ---------------------------------------------------------------------------

def _make(dataset_root: str, version: PipelineVersion, detector=None,
          device="cuda", **overrides) -> FusionPipeline:
    cfg = FusionConfig.for_version(version)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ds = Kitti360Dataset(dataset_root, shapes=cfg.shapes)
    return FusionPipeline(ds, cfg, detector, device=device)


def v1_pointwise(dataset_root: str, detector=None, device="cuda",
                 **kw) -> FusionPipeline:
    """V1_BBox_Pointwise_filtering.py equivalent."""
    return _make(dataset_root, PipelineVersion.V1_POINTWISE, detector,
                 device, **kw)


def v2_stats(dataset_root: str, detector=None, device="cuda",
             **kw) -> FusionPipeline:
    """V2_point_cloud_without_erosion.py equivalent."""
    return _make(dataset_root, PipelineVersion.V2_STATS, detector, device,
                 **kw)


def v3_erosion(dataset_root: str, detector=None, device="cuda",
               **kw) -> FusionPipeline:
    """V3_point_cloud_with_erosion.py equivalent."""
    return _make(dataset_root, PipelineVersion.V3_EROSION, detector, device,
                 **kw)


def v4_iou(dataset_root: str, detector=None, device="cuda",
           **kw) -> FusionPipeline:
    """V4_BBox_IoU_filtering.py equivalent (greedy IoU, depth < 30)."""
    return _make(dataset_root, PipelineVersion.V4_IOU, detector, device,
                 **kw)


def v5_projected(dataset_root: str, detector=None, device="cuda",
                 **kw) -> FusionPipeline:
    """V5_ProjectingBBoxes.py equivalent (Hungarian matching)."""
    return _make(dataset_root, PipelineVersion.V5_PROJECTED, detector,
                 device, **kw)


def csv_eval(dataset_root: str, master_csv: str, detector=None,
             device="cuda", timestamp: Optional[str] = None,
             **kw) -> Optional[dict]:
    """cvs_erosion.py equivalent: one run over the directory, the master
    CSV, and the whole-run analysis."""
    pipe = _make(dataset_root, PipelineVersion.CSV_EVAL, detector, device,
                 **kw)
    pipe.run(master_csv=master_csv, timestamp=timestamp)
    return stats_lib.analyze_master_csv(master_csv)
