"""Host-side 2D drawing -- never on the serving path.

Counterpart of ``lidar_object_detection_tpu/viz/overlay.py`` (lines
18-159), which replaces the reference's OpenCV overlay
(V1_BBox_Pointwise_filtering.py:77-89) and its matplotlib depth-map
figures (seg_with_pointcloud.py:173-194).  Colours follow the reference:
V1's ``(i*60, i*120, i*180) % 255`` BGR tuples (V1:75) and V5's
golden-angle HSV palette (V5:88-121).

The JAX package draws the depth-map figure with matplotlib, which the
card's machine does not promise.  :func:`depth_map_figure` computes the
same two panels -- the depth map through matplotlib's ``jet`` (its own
256-entry copy of the table, :func:`jet_table`) and the segmented image
with those colours where a point landed -- and writes them stacked, at
image resolution and without titles, through ``utils/png.py``.

Packed words are the port's int32 words or JAX's uint32 ones: both are
read as uint32.

Not ported yet: ``draw_label`` and ``annotate_kitti2d_image``, which only
the KITTI 2D evaluation uses (ROADMAP Queue 1 item 6.5).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from lidar_object_detection_tpu_torch.utils.png import write_png_rgb

# matplotlib's ``_jet_data`` (matplotlib/_cm.py): per channel, the
# segments (x, value below x, value above x)
_JET_DATA = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}


def _as_uint32(words) -> np.ndarray:
    words = np.asarray(words)
    return words.view(np.uint32) if words.dtype == np.int32 else \
        words.astype(np.uint32)


def simple_colors(n: int) -> List[Tuple[int, int, int]]:
    """V1's colour table (BGR, as the reference; V1:75)."""
    return [(int(i * 60) % 255, int(i * 120) % 255, int(i * 180) % 255)
            for i in range(n)]


def golden_colors(n: int) -> List[Tuple[int, int, int]]:
    """V5's golden-angle HSV palette in BGR (V5:88-121)."""
    out = []
    for i in range(n):
        hue = (i * 137.508) % 360
        sat = 0.8 + (i % 3) * 0.1
        val = 0.8 + (i % 2) * 0.2
        h_i = int(hue / 60) % 6
        f = (hue / 60) - h_i
        p = val * (1 - sat)
        q = val * (1 - f * sat)
        t = val * (1 - (1 - f) * sat)
        r, g, b = [(val, t, p), (q, val, p), (p, val, t),
                   (p, q, val), (t, p, val), (val, p, q)][h_i]
        out.append((int(b * 255), int(g * 255), int(r * 255)))
    return out


def point_colors_from_bits(point_bits, num_detections: int,
                           colors: Optional[Sequence[Tuple[int, int, int]]]
                           = None, background=(0.5, 0.5, 0.5)) -> np.ndarray:
    """Per-point RGB in [0, 1] from the packed membership words (V1:377-395):
    the lowest detection bit wins, as the reference's first-match loop;
    background points get the reference's grey."""
    bits = _as_uint32(point_bits)
    if colors is None:
        colors = simple_colors(num_detections)
    out = np.tile(np.asarray(background, np.float64), (bits.shape[0], 1))
    assigned = np.zeros(bits.shape[0], bool)
    for d in range(num_detections):
        member = ((bits >> np.uint32(d)) & 1).astype(bool) & ~assigned
        bgr = colors[d]
        out[member] = np.asarray([bgr[2], bgr[1], bgr[0]], np.float64) / 255.0
        assigned |= member
    return out


def analysis_cloud_colors(point_bits, inside_bits, num_detections: int,
                          colors: Optional[Sequence[Tuple[int, int, int]]]
                          = None, mode: str = "inside_outside",
                          background=(0.5, 0.5, 0.5)) -> np.ndarray:
    """Per-point RGB of the V2 bbox-analysis cloud
    (V2_point_cloud_without_erosion.py:446-491).

    ``mode="inside_outside"``: a matched car's points are green inside its
    matched box and red outside it (V2:475-479).  ``mode="car_color"``:
    both get the car's colour, as the shipped reference draws.  Points of
    no car stay grey.
    """
    bits = _as_uint32(point_bits)
    inb = _as_uint32(inside_bits)
    if colors is None:
        colors = simple_colors(num_detections)
    out = np.tile(np.asarray(background, np.float64), (bits.shape[0], 1))
    assigned = np.zeros(bits.shape[0], bool)
    for d in range(num_detections):
        member = ((bits >> np.uint32(d)) & 1).astype(bool) & ~assigned
        inside = ((inb >> np.uint32(d)) & 1).astype(bool)
        if mode == "inside_outside":
            out[member & inside] = (0.0, 1.0, 0.0)
            out[member & ~inside] = (1.0, 0.0, 0.0)
        else:
            bgr = colors[d]
            out[member] = np.asarray([bgr[2], bgr[1], bgr[0]],
                                     np.float64) / 255.0
        assigned |= member
    return out


def overlay_masks(image: np.ndarray, masks: np.ndarray,
                  colors: Optional[Sequence[Tuple[int, int, int]]] = None,
                  alpha: float = 0.4) -> np.ndarray:
    """Blend (N, H, W) instance masks over an RGB uint8 image
    (``cv2.addWeighted(img, 1.0, color_mask, alpha, 0)``, V1:83)."""
    out = image.astype(np.float32)
    if colors is None:
        colors = simple_colors(masks.shape[0])
    for mask, bgr in zip(masks, colors):
        rgb = np.asarray(bgr[::-1], np.float32)
        m = mask > 0.5
        out[m] = np.clip(out[m] + alpha * rgb, 0, 255)
    return out.astype(np.uint8)


def draw_boxes(image: np.ndarray, boxes: np.ndarray,
               colors: Optional[Sequence[Tuple[int, int, int]]] = None,
               thickness: int = 2) -> np.ndarray:
    """Rectangle outlines on an RGB uint8 image."""
    out = image.copy()
    h, w = out.shape[:2]
    if colors is None:
        colors = simple_colors(len(boxes))
    for (x1, y1, x2, y2), bgr in zip(np.asarray(boxes, int), colors):
        rgb = np.asarray(bgr[::-1], np.uint8)
        x1, x2 = np.clip([x1, x2], 0, w - 1)
        y1, y2 = np.clip([y1, y2], 0, h - 1)
        for t in range(thickness):
            xa, ya = max(x1 - t, 0), max(y1 - t, 0)
            xb, yb = min(x2 + t, w - 1), min(y2 + t, h - 1)
            out[ya, xa:xb + 1] = rgb
            out[yb, xa:xb + 1] = rgb
            out[ya:yb + 1, xa] = rgb
            out[ya:yb + 1, xb] = rgb
    return out


def jet_table(n: int = 256) -> np.ndarray:
    """(n, 3) float64 RGB of matplotlib's ``jet`` with n entries, built as
    ``LinearSegmentedColormap`` builds its lookup table."""
    xind = np.linspace(0, 1, n)
    table = np.empty((n, 3))
    for k, channel in enumerate(("red", "green", "blue")):
        data = np.asarray(_JET_DATA[channel], np.float64)
        x, y0, y1 = data[:, 0], data[:, 1], data[:, 2]
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        table[:, k] = np.clip(np.concatenate([
            [y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
            [y0[-1]]]), 0.0, 1.0)
    return table


def jet(values: np.ndarray) -> np.ndarray:
    """(...,) values in [0, 1] -> (..., 3) ``jet`` colours, indexed as a
    matplotlib colormap indexes a float: ``int(x * 256)``, 1.0 to the last
    entry, computed in the values' dtype."""
    xa = np.array(values, copy=True)
    xa *= 256
    xa[xa == 256] = 255
    return jet_table(256)[np.clip(xa.astype(int), 0, 255)]


def depth_map_panels(depth_map: np.ndarray, seg_image: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The two panels of the depth-map figure, (H, W, 3) float64 in [0, 1]:
    ``jet(depth / max)``, and ``seg_image / 255`` with those colours where
    the depth is positive (seg_with_pointcloud.py:173-194)."""
    dm_max = depth_map.max()
    depth_image = jet(depth_map / dm_max) if dm_max > 0 else \
        np.zeros((*depth_map.shape, 3))
    blended = seg_image.astype(np.float64) / 255.0
    blended[depth_map > 0] = depth_image[depth_map > 0]
    return depth_image, blended


def depth_map_figure(depth_map: np.ndarray, seg_image: np.ndarray,
                     car_id: int, frame_id: int, save_path: str) -> None:
    """Write the per-car depth-map figure to ``save_path`` (the reference
    names it ``{frame:010d},depth_map_car_{id:02d}_.png``): the two panels
    of :func:`depth_map_panels` stacked, (2 H, W) RGB.  ``car_id`` and
    ``frame_id`` are in the file name only: the figure has no titles."""
    del car_id, frame_id
    top, bottom = depth_map_panels(depth_map, seg_image)
    figure = np.concatenate([top, bottom], axis=0)
    write_png_rgb(save_path, np.round(figure * 255.0).astype(np.uint8))
