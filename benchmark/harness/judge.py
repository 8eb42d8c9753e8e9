"""The comparison that decides ``correct``: what the timed path produced
in a sample of the window's chunks, against the plain reference on the
same inputs.  A run sends one chunk again and again, so the reference
judges the sampled runs of that chunk against its one reading of it.

* Detections: each frame's program detections and reference detections
  are paired one to one, greedily by IoU >= 0.5.  ``score_gap`` is the
  widest gap of a paired detection's score to its partner's and of an
  unpaired detection's score over the confidence cut (how far the other
  side was from keeping it, so a dropped or spurious detection counts by
  its margin); ``box_gap_px`` the widest gap of a paired detection's box
  corner; ``mask_gap`` the pixels on which a pair's masks differ over the
  pixels of either, summed over the pairs.
* ``count_gap``: the reference fuses the frames' scans and boxes with its
  own detections and masks, and each paired car's point counts are held
  to its partner's: the points by which the program's total and inside
  counts differ, over the larger of each, summed over the pairs; a pair
  whose match or best box differs counts its inside points in full.
* Fusion and rows on the program's masks: the reference fuses the same
  scans and boxes with the program's mask words and detections, and
  counts the entries of ``total_points``, ``best_box``,
  ``points_inside``, ``matched`` and ``box_visible`` that differ from the
  program's (``fusion_mismatch``) and the per-car rows that differ
  (``row_mismatch``): an exact check of the fusion alone.
* ``launch_mismatch``: chunks of the window whose kernel launches were
  not one each of K1, K2, K3 and K5 and none of the others.

Each number has its limit in the configuration's file (``limits``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import scene
from benchmark.harness.system import row_tuples
from benchmark.reference.decode import iou_matrix

NUMBERS = ("score_gap", "box_gap_px", "mask_gap", "count_gap",
           "fusion_mismatch", "row_mismatch", "launch_mismatch")
CALIB = (scene.VELO_TO_RECT, scene.CAM_TO_VELO, scene.INTRINSICS)


def pair(boxes_a, valid_a, boxes_b, valid_b, min_iou=0.5):
    """Greedy one-to-one pairs (i, j) of valid detections by IoU."""
    ia, ib = np.nonzero(valid_a)[0], np.nonzero(valid_b)[0]
    if not len(ia) or not len(ib):
        return []
    iou = iou_matrix(torch.as_tensor(boxes_a[ia]),
                     torch.as_tensor(boxes_b[ib])).numpy()
    pairs, used_a, used_b = [], set(), set()
    for flat in np.argsort(-iou, axis=None, kind="stable"):
        a, b = np.unravel_index(flat, iou.shape)
        if iou[a, b] < min_iou:
            break
        if a in used_a or b in used_b:
            continue
        used_a.add(a)
        used_b.add(b)
        pairs.append((int(ia[a]), int(ib[b])))
    return pairs


def compare(got: Dict, ref: Dict, got_fused: Dict, ref_fused: Dict,
            conf: float, acc: Dict) -> None:
    """Add one chunk's comparison of detections and paired cars' counts
    to ``acc``."""
    for f in range(got["det_valid"].shape[0]):
        gv, rv = got["det_valid"][f], ref["det_valid"][f]
        pairs = pair(got["boxes"][f], gv, ref["boxes"][f], rv)
        acc["detections"] += int(gv.sum()) + int(rv.sum())
        for side, valid, k in ((got, gv, 0), (ref, rv, 1)):
            paired = {p[k] for p in pairs}
            for i in np.nonzero(valid)[0]:
                if int(i) not in paired:
                    acc["score_gap"] = max(acc["score_gap"], float(
                        side["scores"][f, i]) - conf)
        gw = got["mask_bits"][f].astype(np.int64) & 0xFFFFFFFF
        rw = ref["mask_bits"][f].astype(np.int64) & 0xFFFFFFFF
        gf = {k: v[f] for k, v in got_fused.items()}
        rf = {k: v[f] for k, v in ref_fused.items()}
        for i, j in pairs:
            acc["box_gap_px"] = max(acc["box_gap_px"], float(np.abs(
                got["boxes"][f, i] - ref["boxes"][f, j]).max()))
            acc["score_gap"] = max(acc["score_gap"], float(abs(
                got["scores"][f, i] - ref["scores"][f, j])))
            a, b = (gw >> i) & 1, (rw >> j) & 1
            acc["mask_xor"] += int((a ^ b).sum())
            acc["mask_union"] += int((a | b).sum())
            tg, tr = int(gf["total_points"][i]), int(rf["total_points"][j])
            ig, ir = int(gf["points_inside"][i]), int(rf["points_inside"][j])
            same = (bool(gf["matched"][i]) == bool(rf["matched"][j])
                    and int(gf["best_box"][i]) == int(rf["best_box"][j]))
            acc["count_diff"] += abs(tg - tr) + (
                abs(ig - ir) if same else max(ig, ir))
            acc["count_total"] += max(tg, tr) + max(ig, ir)


def host_detections(det: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: det[k].float().cpu().numpy() if k in ("boxes", "scores")
            else det[k].cpu().numpy() for k in ("boxes", "scores",
                                                 "det_valid", "mask_bits")}


def judge(reference, chunk, samples: List[Dict], launch_mismatch: int,
          limits: Dict[str, float], conf: float):
    """The numbers over ``samples`` (each: the program's detections on the
    host, its fused outputs and rows for ``chunk``) and whether each is
    within its limit.  Returns (numbers, correct)."""
    acc = {"detections": 0, "box_gap_px": 0.0, "score_gap": 0.0,
           "mask_xor": 0, "mask_union": 0, "count_diff": 0,
           "count_total": 0}
    fusion_mismatch = row_mismatch = 0
    ref = host_detections(reference.detect(chunk.images))
    ref_fused = reference.fuse(chunk, ref["mask_bits"], ref["det_valid"],
                               CALIB)
    for s in samples:
        compare(s["det"], ref, s["fused"], ref_fused, conf, acc)
        fused = reference.fuse(chunk, s["det"]["mask_bits"],
                               s["det"]["det_valid"], CALIB)
        for key, value in fused.items():
            fusion_mismatch += int((value != s["fused"][key]).sum())
        want = reference.rows(fused, s["det"]["det_valid"])
        for f, rows in enumerate(s["rows"]):
            got = row_tuples(rows)
            row_mismatch += sum(a != b for a, b in zip(got, want[f])) \
                + abs(len(got) - len(want[f]))
    numbers = {
        "score_gap": acc["score_gap"], "box_gap_px": acc["box_gap_px"],
        "mask_gap": acc["mask_xor"] / max(acc["mask_union"], 1),
        "count_gap": acc["count_diff"] / max(acc["count_total"], 1),
        "fusion_mismatch": fusion_mismatch, "row_mismatch": row_mismatch,
        "launch_mismatch": launch_mismatch}
    correct = bool(samples) and acc["detections"] > 0 and all(
        numbers[k] <= limits[k] for k in NUMBERS)
    return numbers, correct
