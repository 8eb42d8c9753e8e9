"""Stack-free mask assembly over a batch of frames: kernels K2 and K3, the
relative cut's peak pass, their plain twins, and the guarded and relative
compositions.

Counterpart of ``lidar_object_detection_tpu/ops/pallas_masks.py``.  The
input is a batch of cropped proto-resolution probability tables
(B, D, mh, mw); the output is one packed 32-bit word per full-resolution
pixel (bit d = detection d), or per-detection pixel counts.  Each pixel
takes the bilinear value of the exact ``jax.image.resize`` taps
(``ops/resize.py``, shared by every frame), compares it with its
detection's cut, and keeps it when the detection is valid and the pixel
lies inside its half-open box [x1, x2) x [y1, y2).  The (B, D, H, W) float
stack is never stored on the kernel path.

* K2 :func:`assemble_masks_cuda` -> (B, H, W) int32 words
  (``pallas_assemble_masks``), one launch for the batch,
* K3 :func:`count_above_cuda` -> (B, D) int32 counts
  (``pallas_count_above``), one launch for the batch,
* :func:`assemble_masks_guarded_batch` -- the committed serving mode
  (``pallas_assemble_masks_guarded``): K3 at the primary threshold, then
  K2, which reads K3's counts and cuts each detection at ``threshold``
  where it keeps >= ``min_pixels`` pixels and at ``floor`` otherwise
  (:class:`Guard`), on the device: two launches, no host sync;
* :func:`peak_cuda` -> (B, D) float32, each valid detection's largest
  interpolated value inside its box (0 where none is, and for an invalid
  detection), one launch for the batch of ``mask_peak_kernel``, which
  visits only the boxes' pixels: the peak of the relative cut
  (``postprocess.py:438-443`` of the JAX package, an XLA reduction over
  the (D, H, W) field there); :func:`peak_batch` composes it.

The plain twins (:func:`assemble_masks_plain`, :func:`count_above_plain`,
:func:`peak_plain`) take the same batched operands and compute the same
interpolation in the same operation order, y first:
``c = wy0 * t[y0] + wy1 * t[y1]``, then ``v = wx0 * c[x0] + wx1 * c[x1]``,
each product and sum rounded on its own, so kernel and twin agree bit for
bit.  Against the JAX package's XLA
path (one dense resize) the values agree to 1-2 ulp; the tests state the
flip bound.

The ``*_batch`` functions take the kernel for a CUDA tensor and the twin
for a CPU tensor.  The single-frame functions (:func:`assemble_masks`,
:func:`count_above`, :func:`assemble_masks_guarded`) are B = 1 calls of
them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops.masks import pack_masks
from lidar_object_detection_tpu_torch.ops.resize import resize_taps
from lidar_object_detection_tpu_torch.utils import profiling

MAX_DET = 32
# a block of K2/K3 covers this many columns (128 threads, 4 pixels each)
TILE_COLS = 512


@functools.lru_cache(maxsize=32)
def _taps_on(n_in: int, n_out: int, device: str):
    idx0, w0, w1 = resize_taps(n_in, n_out)
    return tuple(torch.from_numpy(a.copy()).to(device) for a in (idx0, w0, w1))


@dataclasses.dataclass(frozen=True)
class MaskOperands:
    """The kernels' operands for a batch of frames, on the table's
    device."""

    table: torch.Tensor    # (B, D, mh, mw) float32, contiguous
    y0: torch.Tensor       # (H,) int32 row taps and weights
    wy0: torch.Tensor
    wy1: torch.Tensor
    x0: torch.Tensor       # (W,) int32 column taps and weights
    wx0: torch.Tensor
    wx1: torch.Tensor
    boxes: torch.Tensor    # (B, D, 4) float32 xyxy
    valid: torch.Tensor    # (B, D) bool
    thr: torch.Tensor      # (B, D) float32 cuts

    @property
    def shape(self):
        """(H, W) of the output frames."""
        return self.y0.shape[0], self.x0.shape[0]


@dataclasses.dataclass(frozen=True)
class Guard:
    """The guarded-shrink cut rule: detection d of frame b cuts at the
    operands' ``thr`` where ``counts`` (K3's pixels at ``thr``) reach
    ``min_pixels``, and at ``floor`` otherwise."""

    counts: torch.Tensor   # (B, D) int32
    floor: float
    min_pixels: int


def prepare_operands(table, boxes, det_valid, src_h: int, src_w: int,
                     threshold) -> MaskOperands:
    """Operands of the kernels and twins.

    Args:
      table: (B, D, mh, mw) probabilities at proto resolution, letterbox
        padding already cropped; D <= 32, mh <= src_h, mw <= src_w.
      boxes: (B, D, 4) xyxy in source-image pixels.
      det_valid: (B, D) bool.
      threshold: a float, or a (B, D) tensor of per-detection cuts.
    """
    if table.dim() != 4:
        raise ValueError(f"table must be (B, D, mh, mw), got "
                         f"{tuple(table.shape)}")
    b, d, mh, mw = table.shape
    if d > MAX_DET:
        raise ValueError(f"at most {MAX_DET} detections, got {d}")
    if mh > src_h or mw > src_w:
        raise ValueError(f"upsampling only: {mh}x{mw} -> {src_h}x{src_w}")
    device = table.device
    dev = str(device)
    y0, wy0, wy1 = _taps_on(mh, src_h, dev)
    x0, wx0, wx1 = _taps_on(mw, src_w, dev)
    if isinstance(threshold, torch.Tensor) and threshold.dim() > 0:
        thr = threshold.to(device=device, dtype=torch.float32).expand(b, d)
    else:
        thr = torch.full((b, d), float(threshold), dtype=torch.float32,
                         device=device)
    return MaskOperands(table.to(torch.float32).contiguous(), y0, wy0, wy1,
                        x0, wx0, wx1, boxes.to(torch.float32).contiguous(),
                        det_valid.to(torch.bool).contiguous(),
                        thr.contiguous())


def guarded_cut(thr: torch.Tensor, guard: Guard) -> torch.Tensor:
    """The cuts K2 applies under ``guard``, in plain PyTorch."""
    return torch.where(guard.counts >= guard.min_pixels, thr,
                       torch.tensor(guard.floor, dtype=torch.float32,
                                    device=thr.device))


def _values_plain(ops: MaskOperands, b: int):
    """Frame ``b``'s interpolated values (D, H, W), in the kernels' order,
    and which of them lie inside a valid detection's box."""
    t = ops.table[b]
    mh, mw = t.shape[-2], t.shape[-1]
    r1 = torch.clamp(ops.y0 + 1, max=mh - 1)
    c1 = torch.clamp(ops.x0 + 1, max=mw - 1)
    c = (ops.wy0[:, None] * t[:, ops.y0.long(), :]
         + ops.wy1[:, None] * t[:, r1.long(), :])            # (D, H, mw)
    v = (ops.wx0 * c[..., ops.x0.long()]
         + ops.wx1 * c[..., c1.long()])                      # (D, H, W)
    h, w = ops.shape
    ys = torch.arange(h, dtype=torch.float32, device=t.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=t.device)[None, :]
    x1, y1, x2, y2 = (e[:, None, None] for e in ops.boxes[b].unbind(-1))
    in_box = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2) \
        & ops.valid[b, :, None, None]
    return v, in_box


def _binary_plain(ops: MaskOperands, cut: torch.Tensor,
                  b: int) -> torch.Tensor:
    """(D, H, W) bool of frame ``b``'s pixels that pass, in the kernels'
    order."""
    v, in_box = _values_plain(ops, b)
    return (v > cut[b, :, None, None]) & in_box


def _per_frame(fn, ops: MaskOperands, empty_shape,
               dtype=torch.int32) -> torch.Tensor:
    """Stack ``fn(b)`` over the batch's frames: the twins build one frame's
    (D, H, W) stack at a time, so their memory does not grow with B."""
    b = ops.table.shape[0]
    if b == 0:
        return torch.zeros(empty_shape, dtype=dtype,
                           device=ops.table.device)
    return torch.stack([fn(i) for i in range(b)])


def assemble_masks_plain(ops: MaskOperands,
                         guard: Optional[Guard] = None) -> torch.Tensor:
    """Plain twin of K2: (B, H, W) int32 packed words, cut at ``ops.thr``
    or by ``guard``."""
    cut = ops.thr if guard is None else guarded_cut(ops.thr, guard)
    return _per_frame(lambda b: pack_masks(_binary_plain(ops, cut, b)), ops,
                      (0, *ops.shape))


def count_above_plain(ops: MaskOperands) -> torch.Tensor:
    """Plain twin of K3: (B, D) int32 pixel counts at ``ops.thr``."""
    return _per_frame(
        lambda b: _binary_plain(ops, ops.thr, b).sum(dim=(-2, -1)).to(
            torch.int32), ops, (0, ops.table.shape[1]))


def peak_plain(ops: MaskOperands) -> torch.Tensor:
    """Plain twin of the peak pass: (B, D) float32, the largest value of
    each valid detection's in-box pixels, 0 where it has none."""
    def peak(b):
        v, in_box = _values_plain(ops, b)
        return torch.where(in_box, v, 0.0).amax(dim=(-2, -1))

    return _per_frame(peak, ops, ops.table.shape[:2], torch.float32)


def _check(fn_name: str, ops: MaskOperands, out: torch.Tensor,
           guard: Optional[Guard]) -> None:
    device = ops.table.device
    if device.type != "cuda":
        raise ValueError(f"{fn_name} needs CUDA tensors, got {device}")
    b, d, mh, mw = ops.table.shape
    h, w = ops.shape
    expected = [(ops.table, torch.float32, (b, d, mh, mw)),
                (ops.y0, torch.int32, (h,)), (ops.wy0, torch.float32, (h,)),
                (ops.wy1, torch.float32, (h,)), (ops.x0, torch.int32, (w,)),
                (ops.wx0, torch.float32, (w,)), (ops.wx1, torch.float32, (w,)),
                (ops.boxes, torch.float32, (b, d, 4)),
                (ops.valid, torch.bool, (b, d)),
                (ops.thr, torch.float32, (b, d)),
                (out, torch.int32,
                 (b, h, w) if fn_name == "mask_assemble_launch" else (b, d))]
    if guard is not None:
        expected.append((guard.counts, torch.int32, (b, d)))
    for t, dtype, shape in expected:
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(f"{fn_name}: operands must be contiguous "
                             f"{dtype} of shape {tuple(shape)} on {device}")
    if d > MAX_DET or mh > h or mw > w:
        raise ValueError(f"{fn_name}: needs D <= {MAX_DET} and upsampling, "
                         f"got {d} x {mh} x {mw} -> {h} x {w}")


def launch(fn_name: str, ops: MaskOperands, out: torch.Tensor,
           guard: Optional[Guard] = None) -> None:
    """Launch K3 (``mask_count_launch``, adding into ``out`` (B, D)), the
    peak pass (``mask_peak_launch``, max-ing float bits into ``out``
    (B, D)) or K2 (``mask_assemble_launch``, writing ``out`` (B, H, W)) on
    the current stream.  Counts no launch: the wrappers below do."""
    _check(fn_name, ops, out, guard)
    b, d, mh, mw = ops.table.shape
    h, w = ops.shape
    device = ops.table.device
    args = [ops.table.data_ptr(), b, d, mh, mw, ops.y0.data_ptr(),
            ops.wy0.data_ptr(), ops.wy1.data_ptr(), ops.x0.data_ptr(),
            ops.wx0.data_ptr(), ops.wx1.data_ptr(), ops.boxes.data_ptr(),
            ops.valid.data_ptr()]
    if fn_name != "mask_peak_launch":
        args.append(ops.thr.data_ptr())
    if fn_name == "mask_assemble_launch":
        args += ([None, 0.0, 0] if guard is None else
                 [guard.counts.data_ptr(), float(guard.floor),
                  int(guard.min_pixels)])
    code = getattr(kernel_lib.library(), fn_name)(
        *args, h, w, out.data_ptr(), kernel_lib.stream_handle(device))
    kernel_lib.check(code, fn_name)


def assemble_masks_cuda(ops: MaskOperands,
                        guard: Optional[Guard] = None) -> torch.Tensor:
    """Launch K2: (B, H, W) int32 packed words."""
    b = ops.table.shape[0]
    out = torch.empty((b, *ops.shape), dtype=torch.int32,
                      device=ops.table.device)
    with profiling.span("kernel.mask_assemble"):
        launch("mask_assemble_launch", ops, out, guard)
        kernel_lib.LAUNCHES["mask_assemble"] += 1
    return out


def count_above_cuda(ops: MaskOperands) -> torch.Tensor:
    """Launch K3: (B, D) int32 pixel counts."""
    out = torch.zeros(ops.table.shape[:2], dtype=torch.int32,
                      device=ops.table.device)
    with profiling.span("kernel.mask_count"):
        launch("mask_count_launch", ops, out)
        kernel_lib.LAUNCHES["mask_count"] += 1
    return out


def peak_cuda(ops: MaskOperands) -> torch.Tensor:
    """Launch the peak pass: (B, D) float32 in-box peaks."""
    out = torch.zeros(ops.table.shape[:2], dtype=torch.int32,
                      device=ops.table.device)
    with profiling.span("kernel.mask_peak"):
        launch("mask_peak_launch", ops, out)
        kernel_lib.LAUNCHES["mask_peak"] += 1
    return out.view(torch.float32)


def _on_cpu(ops: MaskOperands) -> bool:
    return ops.table.device.type == "cpu"


def assemble_masks_batch(table, boxes, det_valid, src_h: int, src_w: int,
                         threshold=0.5) -> torch.Tensor:
    """Packed (B, src_h, src_w) int32 mask words of a batch: K2 on CUDA,
    the twin on CPU."""
    ops = prepare_operands(table, boxes, det_valid, src_h, src_w, threshold)
    if _on_cpu(ops):
        return assemble_masks_plain(ops)
    return assemble_masks_cuda(ops)


def count_above_batch(table, boxes, det_valid, src_h: int, src_w: int,
                      threshold=0.5) -> torch.Tensor:
    """(B, D) int32 pixels passing per detection: K3 on CUDA, the twin on
    CPU."""
    ops = prepare_operands(table, boxes, det_valid, src_h, src_w, threshold)
    if _on_cpu(ops):
        return count_above_plain(ops)
    return count_above_cuda(ops)


def peak_batch(table, boxes, det_valid, src_h: int,
               src_w: int) -> torch.Tensor:
    """(B, D) float32 in-box peaks of a batch's interpolated fields: the
    peak pass on CUDA, the twin on CPU."""
    ops = prepare_operands(table, boxes, det_valid, src_h, src_w, 0.0)
    if _on_cpu(ops):
        return peak_plain(ops)
    return peak_cuda(ops)


def assemble_masks_relative_batch(table, boxes, det_valid, src_h: int,
                                  src_w: int,
                                  threshold: float) -> torch.Tensor:
    """Relative-cut assembly of a batch: each detection cuts at the float32
    product ``threshold * peak`` of its in-box peak (the peak pass, then
    K2 with those per-detection cuts on CUDA, no host sync; the twins on
    CPU)."""
    ops = prepare_operands(table, boxes, det_valid, src_h, src_w, 0.0)
    cpu = _on_cpu(ops)
    peak = peak_plain(ops) if cpu else peak_cuda(ops)
    cut = torch.tensor(threshold, dtype=torch.float32,
                       device=peak.device) * peak
    ops = dataclasses.replace(ops, thr=cut.contiguous())
    return assemble_masks_plain(ops) if cpu else assemble_masks_cuda(ops)


def assemble_masks_guarded_batch(table, boxes, det_valid, src_h: int,
                                 src_w: int, threshold: float, floor: float,
                                 min_pixels: int) -> torch.Tensor:
    """Guarded-shrink assembly of a batch in two passes: K3 counts at
    ``threshold``, then K2 with the per-detection cuts picked on the
    device (the twins on CPU)."""
    ops = prepare_operands(table, boxes, det_valid, src_h, src_w, threshold)
    if _on_cpu(ops):
        return assemble_masks_plain(
            ops, Guard(count_above_plain(ops), floor, min_pixels))
    return assemble_masks_cuda(
        ops, Guard(count_above_cuda(ops), floor, min_pixels))


def _frame(threshold):
    if isinstance(threshold, torch.Tensor) and threshold.dim() > 0:
        return threshold[None]
    return threshold


def assemble_masks(table, boxes, det_valid, src_h: int, src_w: int,
                   threshold=0.5) -> torch.Tensor:
    """Packed (src_h, src_w) int32 mask words of one frame (table
    (D, mh, mw), boxes (D, 4), det_valid (D,), threshold a float or (D,)):
    K2 on CUDA, the twin on CPU."""
    return assemble_masks_batch(table[None], boxes[None], det_valid[None],
                                src_h, src_w, _frame(threshold))[0]


def count_above(table, boxes, det_valid, src_h: int, src_w: int,
                threshold=0.5) -> torch.Tensor:
    """(D,) int32 pixels passing per detection of one frame: K3 on CUDA,
    the twin on CPU."""
    return count_above_batch(table[None], boxes[None], det_valid[None],
                             src_h, src_w, _frame(threshold))[0]


def guarded_thresholds(counts: torch.Tensor, threshold: float,
                       floor: float, min_pixels: int) -> torch.Tensor:
    """float32 cuts of the counts' shape: ``threshold`` where the primary
    cut keeps at least ``min_pixels`` pixels, else ``floor``."""
    hi = torch.full(counts.shape, threshold, dtype=torch.float32,
                    device=counts.device)
    return guarded_cut(hi, Guard(counts, floor, min_pixels))


def assemble_masks_guarded(table, boxes, det_valid, src_h: int, src_w: int,
                           threshold: float, floor: float,
                           min_pixels: int) -> torch.Tensor:
    """Guarded-shrink assembly of one frame: K3, then K2 (the twins on
    CPU)."""
    return assemble_masks_guarded_batch(
        table[None], boxes[None], det_valid[None], src_h, src_w, threshold,
        floor, min_pixels)[0]
