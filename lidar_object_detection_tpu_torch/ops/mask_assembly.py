"""Stack-free mask assembly: kernels K2 and K3, their plain twins, and the
guarded composition.

Counterpart of ``lidar_object_detection_tpu/ops/pallas_masks.py``.  The
input is a cropped proto-resolution probability table (D, mh, mw); the
output is one packed 32-bit word per full-resolution pixel (bit d =
detection d), or per-detection pixel counts.  Each pixel takes the
bilinear value of the exact ``jax.image.resize`` taps (``ops/resize.py``),
compares it with its detection's threshold, and keeps it inside the
detection's half-open box [x1, x2) x [y1, y2); an invalid detection gets an
empty box.  The (D, H, W) float stack is never stored on the kernel path.

* K2 :func:`assemble_masks_cuda` -> (H, W) int32 words
  (``pallas_assemble_masks``),
* K3 :func:`count_above_cuda` -> (D,) int32 counts (``pallas_count_above``),
* :func:`assemble_masks_guarded` -- the committed serving mode
  (``pallas_assemble_masks_guarded``): K3 at the primary threshold, then
  each detection serves ``threshold`` when it keeps >= ``min_pixels``
  pixels and ``floor`` otherwise, then K2 at those per-detection cuts.

The plain twins (:func:`assemble_masks_plain`, :func:`count_above_plain`)
compute the same interpolation in the same operation order, y first:
``c = wy0 * t[y0] + wy1 * t[y1]``, then ``v = wx0 * c[x0] + wx1 * c[x1]``,
each product and sum rounded on its own, so kernel and twin agree bit for
bit.  Against the JAX package's XLA path (one dense resize) the values
agree to 1-2 ulp; the tests state the flip bound.

:func:`assemble_masks` / :func:`count_above` take the kernel for a CUDA
tensor and the twin for a CPU tensor.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops.masks import pack_masks
from lidar_object_detection_tpu_torch.ops.resize import resize_taps

MAX_DET = 32


@functools.lru_cache(maxsize=32)
def _taps_on(n_in: int, n_out: int, device: str):
    idx0, w0, w1 = resize_taps(n_in, n_out)
    return tuple(torch.from_numpy(a.copy()).to(device) for a in (idx0, w0, w1))


@dataclasses.dataclass(frozen=True)
class MaskOperands:
    """The kernels' operands, prepared on the table's device."""

    table: torch.Tensor    # (D, mh, mw) float32, contiguous
    y0: torch.Tensor       # (H,) int32 row taps and weights
    wy0: torch.Tensor
    wy1: torch.Tensor
    x0: torch.Tensor       # (W,) int32 column taps and weights
    wx0: torch.Tensor
    wx1: torch.Tensor
    boxes: torch.Tensor    # (D, 4) float32 xyxy, invalid -> empty
    thr: torch.Tensor      # (D,) float32

    @property
    def shape(self):
        return self.y0.shape[0], self.x0.shape[0]


def prepare_operands(table, boxes, det_valid, src_h: int, src_w: int,
                     threshold) -> MaskOperands:
    """Operands of the kernels and twins.

    Args:
      table: (D, mh, mw) probabilities at proto resolution, letterbox
        padding already cropped; D <= 32, mh <= src_h, mw <= src_w.
      boxes: (D, 4) xyxy in source-image pixels.
      det_valid: (D,) bool.
      threshold: a float, or a (D,) tensor of per-detection cuts.
    """
    d, mh, mw = table.shape
    if d > MAX_DET:
        raise ValueError(f"at most {MAX_DET} detections, got {d}")
    if mh > src_h or mw > src_w:
        raise ValueError(f"upsampling only: {mh}x{mw} -> {src_h}x{src_w}")
    device = table.device
    dev = str(device)
    y0, wy0, wy1 = _taps_on(mh, src_h, dev)
    x0, wx0, wx1 = _taps_on(mw, src_w, dev)
    empty = torch.tensor([src_w, src_h, src_w, src_h], dtype=torch.float32,
                         device=device)
    boxes = torch.where(det_valid[:, None], boxes.to(torch.float32),
                        empty[None, :]).contiguous()
    if isinstance(threshold, torch.Tensor) and threshold.dim() == 1:
        thr = threshold.to(device=device, dtype=torch.float32)
    else:
        thr = torch.full((d,), float(threshold), dtype=torch.float32,
                         device=device)
    return MaskOperands(table.to(torch.float32).contiguous(), y0, wy0, wy1,
                        x0, wx0, wx1, boxes, thr.contiguous())


def _binary_plain(ops: MaskOperands) -> torch.Tensor:
    """(D, H, W) bool of the pixels that pass, in the kernels' order."""
    t = ops.table
    mh, mw = t.shape[1], t.shape[2]
    y1 = torch.clamp(ops.y0 + 1, max=mh - 1)
    x1 = torch.clamp(ops.x0 + 1, max=mw - 1)
    c = (ops.wy0[None, :, None] * t[:, ops.y0.long(), :]
         + ops.wy1[None, :, None] * t[:, y1.long(), :])        # (D, H, mw)
    v = (ops.wx0 * c[:, :, ops.x0.long()]
         + ops.wx1 * c[:, :, x1.long()])                       # (D, H, W)
    h, w = ops.shape
    ys = torch.arange(h, dtype=torch.float32, device=t.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=t.device)[None, None, :]
    b = ops.boxes[:, :, None, None]
    in_box = (xs >= b[:, 0]) & (xs < b[:, 2]) & (ys >= b[:, 1]) \
        & (ys < b[:, 3])
    return (v > ops.thr[:, None, None]) & in_box


def assemble_masks_plain(ops: MaskOperands) -> torch.Tensor:
    """Plain twin of K2: (H, W) int32 packed words."""
    return pack_masks(_binary_plain(ops))


def count_above_plain(ops: MaskOperands) -> torch.Tensor:
    """Plain twin of K3: (D,) int32 pixel counts."""
    return _binary_plain(ops).sum(dim=(1, 2)).to(torch.int32)


def _launch(fn_name: str, ops: MaskOperands, out: torch.Tensor) -> None:
    device = ops.table.device
    if device.type != "cuda":
        raise ValueError(f"{fn_name} needs CUDA tensors, got {device}")
    d, mh, mw = ops.table.shape
    h, w = ops.shape
    expected = ((ops.table, torch.float32, (d, mh, mw)),
                (ops.y0, torch.int32, (h,)), (ops.wy0, torch.float32, (h,)),
                (ops.wy1, torch.float32, (h,)), (ops.x0, torch.int32, (w,)),
                (ops.wx0, torch.float32, (w,)), (ops.wx1, torch.float32, (w,)),
                (ops.boxes, torch.float32, (d, 4)),
                (ops.thr, torch.float32, (d,)))
    for t, dtype, shape in expected + ((out, torch.int32, out.shape),):
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(f"{fn_name}: operands must be contiguous "
                             f"{dtype} of shape {tuple(shape)} on {device}")
    if d > MAX_DET or mh > h or mw > w:
        raise ValueError(f"{fn_name}: needs D <= {MAX_DET} and upsampling, "
                         f"got {d} x {mh} x {mw} -> {h} x {w}")
    lib = kernel_lib.library()
    code = getattr(lib, fn_name)(
        ops.table.data_ptr(), d, mh, mw, ops.y0.data_ptr(),
        ops.wy0.data_ptr(), ops.wy1.data_ptr(), ops.x0.data_ptr(),
        ops.wx0.data_ptr(), ops.wx1.data_ptr(), ops.boxes.data_ptr(),
        ops.thr.data_ptr(), h, w, out.data_ptr(),
        kernel_lib.stream_handle(device))
    kernel_lib.check(code, fn_name)


def assemble_masks_cuda(ops: MaskOperands) -> torch.Tensor:
    """Launch K2: (H, W) int32 packed words."""
    out = torch.empty(ops.shape, dtype=torch.int32, device=ops.table.device)
    _launch("mask_assemble_launch", ops, out)
    kernel_lib.LAUNCHES["mask_assemble"] += 1
    return out


def count_above_cuda(ops: MaskOperands) -> torch.Tensor:
    """Launch K3: (D,) int32 pixel counts."""
    out = torch.zeros((ops.table.shape[0],), dtype=torch.int32,
                      device=ops.table.device)
    _launch("mask_count_launch", ops, out)
    kernel_lib.LAUNCHES["mask_count"] += 1
    return out


def assemble_masks(table, boxes, det_valid, src_h: int, src_w: int,
                   threshold=0.5) -> torch.Tensor:
    """Packed (src_h, src_w) int32 mask words: K2 on CUDA, the twin on CPU."""
    ops = prepare_operands(table, boxes, det_valid, src_h, src_w, threshold)
    if ops.table.device.type == "cpu":
        return assemble_masks_plain(ops)
    return assemble_masks_cuda(ops)


def count_above(table, boxes, det_valid, src_h: int, src_w: int,
                threshold=0.5) -> torch.Tensor:
    """(D,) int32 pixels passing per detection: K3 on CUDA, the twin on
    CPU."""
    ops = prepare_operands(table, boxes, det_valid, src_h, src_w, threshold)
    if ops.table.device.type == "cpu":
        return count_above_plain(ops)
    return count_above_cuda(ops)


def guarded_thresholds(counts: torch.Tensor, threshold: float,
                       floor: float, min_pixels: int) -> torch.Tensor:
    """(D,) float32: ``threshold`` where the primary cut keeps at least
    ``min_pixels`` pixels, else ``floor``."""
    hi = torch.full(counts.shape, threshold, dtype=torch.float32,
                    device=counts.device)
    lo = torch.full_like(hi, floor)
    return torch.where(counts >= min_pixels, hi, lo)


def assemble_masks_guarded(table, boxes, det_valid, src_h: int, src_w: int,
                           threshold: float, floor: float,
                           min_pixels: int) -> torch.Tensor:
    """Guarded-shrink assembly in two passes: K3 counts at ``threshold``,
    per-detection cuts, K2 (the twins on CPU)."""
    counts = count_above(table, boxes, det_valid, src_h, src_w, threshold)
    thr = guarded_thresholds(counts, threshold, floor, min_pixels)
    return assemble_masks(table, boxes, det_valid, src_h, src_w, thr)
