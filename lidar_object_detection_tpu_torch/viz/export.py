"""3D scene export to ASCII PLY files.

Counterpart of ``lidar_object_detection_tpu/viz/export.py`` (lines
28-91), which replaces the reference's interactive Open3D windows
(``draw_geometries`` and a blocking ``input()``,
V1_BBox_Pointwise_filtering.py:420-429): coloured point clouds and box
wireframes, written byte for byte as the JAX package writes them.  The
edge list is the reference's (V1:281-285); the early prototypes' vertical
edges (firsttest.py:158-162) are ``edge_style="proto"``.

Not ported: ``show_open3d``, the optional interactive viewer, since the
card's machine has no open3d.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

BOX_EDGES_V1 = ((0, 1), (1, 3), (3, 2), (2, 0),
                (4, 5), (5, 7), (7, 6), (6, 4),
                (0, 5), (1, 4), (2, 7), (3, 6))
BOX_EDGES_PROTO = ((0, 1), (1, 3), (3, 2), (2, 0),
                   (4, 5), (5, 7), (7, 6), (6, 4),
                   (0, 4), (1, 5), (2, 6), (3, 7))


def box_edges(edge_style: str = "v1"):
    return BOX_EDGES_V1 if edge_style == "v1" else BOX_EDGES_PROTO


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None,
              edges: Optional[Sequence[Tuple[int, int]]] = None) -> None:
    """Write points (N, 3), optional colours (N, 3) in [0, 1] and an
    optional edge list (pairs of point indices) as ASCII PLY."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(points)
    if colors is None:
        colors = np.full((n, 3), 0.5)
    rgb = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
    lines = [
        "ply", "format ascii 1.0",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
    ]
    if edges:
        lines += [f"element edge {len(edges)}",
                  "property int vertex1", "property int vertex2"]
    lines.append("end_header")
    for p, c in zip(points, rgb):
        lines.append(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}")
    if edges:
        for a, b in edges:
            lines.append(f"{a} {b}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_fusion_scene(path: str, points: np.ndarray,
                        point_colors: Optional[np.ndarray],
                        matched_boxes: Sequence[dict],
                        box_colors: Optional[Sequence] = None,
                        edge_style: str = "v1") -> None:
    """One frame's fused scene: the coloured cloud and the matched boxes'
    wireframes.  ``matched_boxes`` is the runner's ``matched_pairs`` list
    (each with (8, 3) ``corners_velo``; V5's unmatched boxes carry their
    grey ``color``)."""
    all_pts = [np.asarray(points).reshape(-1, 3)]
    all_cols = [point_colors if point_colors is not None
                else np.full((len(all_pts[0]), 3), 0.5)]
    edges: List[Tuple[int, int]] = []
    offset = len(all_pts[0])
    e_list = box_edges(edge_style)
    for i, pair in enumerate(matched_boxes):
        corners = np.asarray(pair["corners_velo"]).reshape(8, 3)
        if box_colors is not None:
            color = np.asarray(box_colors[i])
        elif "color" in pair:
            color = np.asarray(pair["color"])
        else:
            color = np.asarray([1.0, 0.0, 0.0])
        all_pts.append(corners)
        all_cols.append(np.tile(color, (8, 1)))
        edges.extend((offset + a, offset + b) for a, b in e_list)
        offset += 8
    write_ply(path, np.concatenate(all_pts, 0),
              np.concatenate(all_cols, 0), edges)
