# Frozen copy of chip_smoke.py:255-257 (the peaks), 693-700 (bound_ms), 812-836 (k1_bytes, k1_bound) and, adapted to take arrays, 962-999 (mask_bound) at 072d88e.
"""The least time the chip could take for a kernel's work, for the
roofline shares: the operations or bytes the kernel's function needs for
its operands, at the published peaks of one H100 SXM (NVIDIA's data
sheet, dense, at a 700 W limit).

K1 (``inside_counts``): 15 operations per (active point, valid box) pair
of each frame, and every membership word read once, the coordinates of
the active points counted in the 32-byte sectors they lie in, the valid
boxes' corners, the box mask and the counts written once.  K2
(``mask_assemble``): for each valid box, 3 operations per (output row,
table column it reaches) and 4 per (pixel, detection) pair inside it, and
the table rows and columns it reaches, the taps, every slot's box, flag
and cut, the counts read and the words written once.
"""

import numpy as np
import torch


# Published peaks of one H100 SXM (NVIDIA's data sheet) at a 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# dense peaks by the dtype the network computes in
PEAK_FLOPS_PER_S = {"bfloat16": 989e12, "float32": PEAK_FP32_PER_S}
D = 32


def bound_ms(n_bytes, n_ops):
    """The least time for the work: bytes at the memory rate or fp32
    operations at the peak rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")



def k1_bytes(bits, mask, d=D):
    """The bytes K1's function must move: every membership word read once,
    the coordinates of the active points only (a point whose word is 0
    needs none), counted in the 32-byte sectors they lie in, the valid
    boxes' corners, the box mask, and the counts written once."""
    import torch

    b, p = bits.shape
    g = mask.shape[1]
    frame, point = (bits != 0).nonzero(as_tuple=True)
    first = (frame * p + point) * 12           # (B, P, 3) float32
    sectors = torch.cat([first // 32, (first + 11) // 32]).unique().numel()
    return (b * p * 4 + sectors * 32 + int(mask.sum()) * 8 * 3 * 4
            + b * (g + d * g * 4 + d * 4))


def k1_bound(pts, bits, corners, mask, d=D):
    """K1's bound: 15 operations per (active point, valid box) pair of
    each frame (an invalid box holds no point by definition, so the
    function does no work for it), and ``k1_bytes``.  Returns (active
    points, pairs, (ms, by))."""
    active = (bits != 0).sum(dim=1)
    pairs = int((active * mask.sum(dim=1)).sum())
    return int(active.sum()), pairs, bound_ms(k1_bytes(bits, mask, d),
                                              pairs * 15)


def mask_bound(table_shape, out_hw, y0, x0, boxes, valid, count):
    """Bound of K3 (``count``) or K2 on a batch's operands: the table's
    (B, D, mh, mw) shape, the output (H, W), the first row and column tap
    of each output row and column (``y0`` (H,), ``x0`` (W,) int), the
    detections' boxes (B, D, 4) and validity (B, D) as numpy arrays."""
    b, d, mh, mw = table_shape
    h, w = out_hw
    bx = np.asarray(boxes, np.float64)
    ok = np.asarray(valid) & (bx[..., 0] < bx[..., 2]) \
        & (bx[..., 1] < bx[..., 3])
    cx = np.clip(np.ceil(np.nan_to_num(bx[..., [0, 2]])), 0, w).astype(int)
    cy = np.clip(np.ceil(np.nan_to_num(bx[..., [1, 3]])), 0, h).astype(int)
    table_bytes, ops_count = 0, 0.0
    row_used = np.zeros(h, bool)
    col_used = np.zeros(w, bool)
    for i in zip(*np.nonzero(ok & (cx[..., 0] < cx[..., 1])
                             & (cy[..., 0] < cy[..., 1]))):
        (xa, xb), (ya, yb) = cx[i], cy[i]
        n_rows = min(y0[yb - 1] + 1, mh - 1) - y0[ya] + 1
        n_cols = min(x0[xb - 1] + 1, mw - 1) - x0[xa] + 1
        table_bytes += n_rows * n_cols * 4
        ops_count += 3 * (yb - ya) * n_cols + 4 * (yb - ya) * (xb - xa)
        row_used[ya:yb] = True
        col_used[xa:xb] = True
    n_bytes = table_bytes + (int(row_used.sum()) + int(col_used.sum())) * 12 \
        + b * d * (16 + 1 + 4) + b * d * 4
    if not count:
        n_bytes += b * h * w * 4
    return bound_ms(n_bytes, ops_count)

