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

The KITTI 2D evaluation's annotated image (:func:`annotate_kitti2d_image`)
has the JAX package's boxes, label anchors, background blend and layout.
The JAX package draws the label text with PIL's default font, which the
card's machine does not promise; :func:`draw_label` draws it with a 5 x 8
bitmap font of this module's own (:data:`FONT`, printable ASCII, one
pixel colour, no antialiasing), so the text and the size of its
background rectangle differ from the JAX package's.
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


# ---------------------------------------------------------------------------
# the KITTI 2D annotation: a bitmap font and labels
# ---------------------------------------------------------------------------

GLYPH_W, GLYPH_H, ADVANCE = 5, 8, 6
# printable ASCII, 5 x 8 glyphs: 8 rows of 5 pixels, top row first, the
# last row for descenders
_GLYPHS = {
    " ": "00000 00000 00000 00000 00000 00000 00000 00000",
    "!": "00100 00100 00100 00100 00100 00000 00100 00000",
    '"': "01010 01010 01010 00000 00000 00000 00000 00000",
    "#": "01010 01010 11111 01010 11111 01010 01010 00000",
    "$": "00100 01111 10100 01110 00101 11110 00100 00000",
    "%": "11000 11001 00010 00100 01000 10011 00011 00000",
    "&": "01100 10010 10100 01000 10101 10010 01101 00000",
    "'": "00100 00100 01000 00000 00000 00000 00000 00000",
    "(": "00010 00100 01000 01000 01000 00100 00010 00000",
    ")": "01000 00100 00010 00010 00010 00100 01000 00000",
    "*": "00000 00100 10101 01110 10101 00100 00000 00000",
    "+": "00000 00100 00100 11111 00100 00100 00000 00000",
    ",": "00000 00000 00000 00000 00000 01100 00100 01000",
    "-": "00000 00000 00000 11111 00000 00000 00000 00000",
    ".": "00000 00000 00000 00000 00000 01100 01100 00000",
    "/": "00000 00001 00010 00100 01000 10000 00000 00000",
    "0": "01110 10001 10011 10101 11001 10001 01110 00000",
    "1": "00100 01100 00100 00100 00100 00100 01110 00000",
    "2": "01110 10001 00001 00010 00100 01000 11111 00000",
    "3": "11111 00010 00100 00010 00001 10001 01110 00000",
    "4": "00010 00110 01010 10010 11111 00010 00010 00000",
    "5": "11111 10000 11110 00001 00001 10001 01110 00000",
    "6": "00110 01000 10000 11110 10001 10001 01110 00000",
    "7": "11111 00001 00010 00100 01000 01000 01000 00000",
    "8": "01110 10001 10001 01110 10001 10001 01110 00000",
    "9": "01110 10001 10001 01111 00001 00010 01100 00000",
    ":": "00000 01100 01100 00000 01100 01100 00000 00000",
    ";": "00000 01100 01100 00000 01100 00100 01000 00000",
    "<": "00010 00100 01000 10000 01000 00100 00010 00000",
    "=": "00000 00000 11111 00000 11111 00000 00000 00000",
    ">": "01000 00100 00010 00001 00010 00100 01000 00000",
    "?": "01110 10001 00001 00010 00100 00000 00100 00000",
    "@": "01110 10001 00001 01101 10101 10101 01110 00000",
    "A": "01110 10001 10001 10001 11111 10001 10001 00000",
    "B": "11110 10001 10001 11110 10001 10001 11110 00000",
    "C": "01110 10001 10000 10000 10000 10001 01110 00000",
    "D": "11100 10010 10001 10001 10001 10010 11100 00000",
    "E": "11111 10000 10000 11110 10000 10000 11111 00000",
    "F": "11111 10000 10000 11110 10000 10000 10000 00000",
    "G": "01110 10001 10000 10111 10001 10001 01111 00000",
    "H": "10001 10001 10001 11111 10001 10001 10001 00000",
    "I": "01110 00100 00100 00100 00100 00100 01110 00000",
    "J": "00111 00010 00010 00010 00010 10010 01100 00000",
    "K": "10001 10010 10100 11000 10100 10010 10001 00000",
    "L": "10000 10000 10000 10000 10000 10000 11111 00000",
    "M": "10001 11011 10101 10101 10001 10001 10001 00000",
    "N": "10001 10001 11001 10101 10011 10001 10001 00000",
    "O": "01110 10001 10001 10001 10001 10001 01110 00000",
    "P": "11110 10001 10001 11110 10000 10000 10000 00000",
    "Q": "01110 10001 10001 10001 10101 10010 01101 00000",
    "R": "11110 10001 10001 11110 10100 10010 10001 00000",
    "S": "01111 10000 10000 01110 00001 00001 11110 00000",
    "T": "11111 00100 00100 00100 00100 00100 00100 00000",
    "U": "10001 10001 10001 10001 10001 10001 01110 00000",
    "V": "10001 10001 10001 10001 10001 01010 00100 00000",
    "W": "10001 10001 10001 10101 10101 10101 01010 00000",
    "X": "10001 10001 01010 00100 01010 10001 10001 00000",
    "Y": "10001 10001 10001 01010 00100 00100 00100 00000",
    "Z": "11111 00001 00010 00100 01000 10000 11111 00000",
    "[": "01110 01000 01000 01000 01000 01000 01110 00000",
    "\\": "00000 10000 01000 00100 00010 00001 00000 00000",
    "]": "01110 00010 00010 00010 00010 00010 01110 00000",
    "^": "00100 01010 10001 00000 00000 00000 00000 00000",
    "_": "00000 00000 00000 00000 00000 00000 11111 00000",
    "`": "01000 00100 00010 00000 00000 00000 00000 00000",
    "a": "00000 00000 01110 00001 01111 10001 01111 00000",
    "b": "10000 10000 10110 11001 10001 10001 11110 00000",
    "c": "00000 00000 01110 10000 10000 10001 01110 00000",
    "d": "00001 00001 01101 10011 10001 10001 01111 00000",
    "e": "00000 00000 01110 10001 11111 10000 01110 00000",
    "f": "00110 01001 01000 11100 01000 01000 01000 00000",
    "g": "00000 00000 01111 10001 10001 01111 00001 01110",
    "h": "10000 10000 10110 11001 10001 10001 10001 00000",
    "i": "00100 00000 01100 00100 00100 00100 01110 00000",
    "j": "00010 00000 00110 00010 00010 00010 10010 01100",
    "k": "10000 10000 10010 10100 11000 10100 10010 00000",
    "l": "01100 00100 00100 00100 00100 00100 01110 00000",
    "m": "00000 00000 11010 10101 10101 10001 10001 00000",
    "n": "00000 00000 10110 11001 10001 10001 10001 00000",
    "o": "00000 00000 01110 10001 10001 10001 01110 00000",
    "p": "00000 00000 11110 10001 10001 11110 10000 10000",
    "q": "00000 00000 01111 10001 10001 01111 00001 00001",
    "r": "00000 00000 10110 11001 10000 10000 10000 00000",
    "s": "00000 00000 01111 10000 01110 00001 11110 00000",
    "t": "01000 01000 11100 01000 01000 01001 00110 00000",
    "u": "00000 00000 10001 10001 10001 10011 01101 00000",
    "v": "00000 00000 10001 10001 10001 01010 00100 00000",
    "w": "00000 00000 10001 10001 10101 10101 01010 00000",
    "x": "00000 00000 10001 01010 00100 01010 10001 00000",
    "y": "00000 00000 10001 10001 10001 01111 00001 01110",
    "z": "00000 00000 11111 00010 00100 01000 11111 00000",
    "{": "00010 00100 00100 01000 00100 00100 00010 00000",
    "|": "00100 00100 00100 00100 00100 00100 00100 00000",
    "}": "01000 00100 00100 00010 00100 00100 01000 00000",
    "~": "00000 00000 01000 10101 00010 00000 00000 00000",
}
# character -> (GLYPH_H, GLYPH_W) bool
FONT = {c: np.array([[bit == "1" for bit in row] for row in rows.split()])
        for c, rows in _GLYPHS.items()}


def text_size(text: str) -> Tuple[int, int]:
    """(width, height) in pixels of ``text`` in :data:`FONT`."""
    return max(ADVANCE * len(text) - 1, 0), GLYPH_H


def draw_text(image: np.ndarray, text: str, top_left: Tuple[int, int],
              color: Tuple[int, int, int]) -> None:
    """Draw ``text`` into (H, W, 3) uint8 ``image`` in place, its first
    glyph's top-left pixel at ``top_left`` (x, y), clipped to the image;
    a character outside printable ASCII draws as ``?``."""
    h, w = image.shape[:2]
    x, y = int(top_left[0]), int(top_left[1])
    rgb = np.asarray(color, np.uint8)
    for i, ch in enumerate(text):
        glyph = FONT.get(ch, FONT["?"])
        gx = x + ADVANCE * i
        ys, xs = np.nonzero(glyph)
        ys, xs = ys + y, xs + gx
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        image[ys[keep], xs[keep]] = rgb


def label_rect(text: str, position: Tuple[int, int],
               shape) -> Tuple[int, int, int, int]:
    """(y0, y1, x0, x1) of :func:`draw_label`'s background rectangle in an
    image of ``shape``: the text lies inside it."""
    x, y = int(position[0]), int(position[1])
    tw, th = text_size(text)
    h, w = shape[:2]
    return max(y - th - 2, 0), min(y + 2, h), max(x, 0), min(x + tw + 5, w)


def draw_label(image: np.ndarray, text: str, position: Tuple[int, int],
               text_color: Tuple[int, int, int] = (255, 255, 255),
               bg_color: Tuple[int, int, int] = (0, 0, 0),
               alpha: float = 0.6) -> np.ndarray:
    """Text over an alpha-blended background rectangle on an RGB uint8
    image: ``draw_text_with_background`` (ObjectDetection_final.py:47-76).
    ``position`` is the text's baseline anchor, as cv2.putText's; colours
    are RGB.  The rectangle spans 2 pixels above the text to 2 below the
    anchor and 5 past the text's end, as in the JAX package."""
    arr = np.array(image, dtype=np.uint8, copy=True)
    x, y = int(position[0]), int(position[1])
    _, th = text_size(text)
    y0, y1, x0, x1 = label_rect(text, position, arr.shape)
    if y1 > y0 and x1 > x0:
        patch = arr[y0:y1, x0:x1].astype(np.float32)
        bg = np.asarray(bg_color, np.float32)
        arr[y0:y1, x0:x1] = (alpha * bg + (1 - alpha) * patch).astype(
            np.uint8)
    draw_text(arr, text, (x, y - th), text_color)
    return arr


def kitti2d_labels(matches, precision: float, recall: float, shape):
    """The labels of :func:`annotate_kitti2d_image` in drawing order, each
    (text, position, text colour, background colour, alpha): five per
    match, then the recall and precision banner."""
    h, w = shape[:2]
    white = (255, 255, 255)
    y_off = 250
    sum_x = min(1000, max(w - 400, 0))
    labels = []
    for m in matches:
        x1, y1 = int(m.det_box[0]), int(m.det_box[1])
        labels += [
            (f"ID: {m.car_id}", (x1, y1 - 35), (0, 0, 0), white, 0.6),
            (f"IoU: {m.iou:.2f}", (x1, y1 - 20), (219, 22, 107), white, 0.6),
            (f"YOLO: {m.yolo_distance:.2f}m", (x1, y1 - 5), (255, 0, 0),
             white, 0.6),
            (f"GT: {m.gt_distance:.2f}m", (x1, y1 + 10), (0, 255, 0), white,
             0.6),
            (f"ID: {m.car_id:.2f} ; gt: {m.gt_distance:.2f}m ; "
             f"yolo: {m.yolo_distance:.2f} m; IoU: {m.iou:.2f}",
             (sum_x, y_off), (0, 0, 0), white, 0.6)]
        y_off += 15
    labels.append((f"Recall: {recall:.2f} ; Precision: {precision:.2f}",
                   (min(420, max(w - 500, 0)), min(330, h - 10)),
                   (232, 67, 67), white, 0.0))
    return labels


def annotate_kitti2d_image(image: np.ndarray, matches,
                           precision: float, recall: float) -> np.ndarray:
    """The reference's annotated KITTI 2D result image
    (ObjectDetection_final.py:166-253): per matched detection a box and
    four labels (ID / IoU / YOLO distance / GT distance) about its top-left
    corner, a running summary column on the right, and the image's recall
    and precision banner.  ``matches`` are ``eval.kitti2d.MatchRecord``s.
    RGB in, RGB out."""
    out = image.copy()
    labels = kitti2d_labels(matches, precision, recall, out.shape)
    for i, m in enumerate(matches):
        x1, y1, x2, y2 = [int(v) for v in m.det_box]
        # the JAX package's colour, "BGR red" in its comment: it draws
        # (255, 0, 0) reversed, blue in RGB
        out = draw_boxes(out, np.asarray([[x1, y1, x2, y2]]),
                         colors=[(0, 0, 255)], thickness=1)
        for text, pos, color, bg, alpha in labels[5 * i:5 * i + 5]:
            out = draw_label(out, text, pos, text_color=color, bg_color=bg,
                             alpha=alpha)
    text, pos, color, bg, alpha = labels[-1]
    return draw_label(out, text, pos, text_color=color, bg_color=bg,
                      alpha=alpha)
