"""The serving assignment solver of V5: the shortest-augmenting-path
solver as a CUDA kernel, with its plain twin.

Counterpart of ``lidar_object_detection_tpu/ops/lap.py`` (``lap``, a
fixed-trip ``lax.scan`` nest that XLA compiles into one loop on the
device).  Written op by op in PyTorch, that nest launches some ten small
kernels for each of its R * 2R steps, on the order of 10^4 launches per
batch at V5's 32 x 384; the kernel does the whole solve in one launch.

* :func:`lap_plain` follows JAX's fixed-trip form step for step, frames
  side by side on a leading axis: R phases, each of R Dijkstra steps
  frozen by ``done`` once the phase reaches an unassigned column, and R
  augmentation steps.  It is the CPU path and the kernel's oracle on the
  card.
* :func:`lap_cuda` launches ``csrc/lap.cu`` on CUDA tensors, one warp
  per frame, all frames of a batch in one launch, and raises on anything
  else.  Its loops stop at the phase's first unassigned column,
  as :func:`.hungarian.hungarian` does: the pops and dual updates are
  those of the fixed-trip form, so the result is the same.
* :func:`lap` takes the twin for a CPU tensor and the kernel for a CUDA
  tensor.

All three compute in float32 in JAX's order --
``((min_val + cost[i]) - u[i]) - v`` for a candidate,
``(u + min_val) - spc[col4row]`` and ``v - (min_val - spc)`` for the
duals -- with ``PAD_COST`` written into masked rows and columns first, and
break argmin ties to the lowest index as ``jnp.argmin`` does.  So padded
rows, whose costs all tie, are solved alike by the three.
"""

from __future__ import annotations

import torch

from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops.hungarian import (PAD_COST,
                                                            masked_cost)
from lidar_object_detection_tpu_torch.utils import profiling

__all__ = ["PAD_COST", "lap", "lap_cuda", "lap_plain"]


def _batched(cost, row_mask, col_mask):
    """(R, C) or (B, R, C) costs and optional masks -> batched float32
    costs, masks filled with True where not given, and whether the input
    was one frame."""
    single = cost.dim() == 2
    if single:
        cost = cost[None]
        row_mask = None if row_mask is None else row_mask[None]
        col_mask = None if col_mask is None else col_mask[None]
    b, r, c = cost.shape
    if row_mask is None:
        row_mask = torch.ones((b, r), dtype=torch.bool, device=cost.device)
    if col_mask is None:
        col_mask = torch.ones((b, c), dtype=torch.bool, device=cost.device)
    return cost, row_mask, col_mask, single


def lap_plain(cost, row_mask=None, col_mask=None, return_scans=False):
    """Exact min-cost assignment of (R, C) costs, R <= C, or of a batch
    (B, R, C), in plain PyTorch.  Returns col4row, (R,) or (B, R) int32.

    With ``return_scans`` it also returns each frame's number of scanned
    columns over all phases, (B,) int64: the Dijkstra steps the dynamic
    solver makes (the kernel's dependent chain and work).
    """
    cost, row_mask, col_mask, single = _batched(cost, row_mask, col_mask)
    cost = masked_cost(cost, row_mask, col_mask)
    b, r, c = cost.shape
    dev = cost.device
    inf = torch.tensor(float("inf"), device=dev)
    cols = torch.arange(c, device=dev)
    rows = torch.arange(r, device=dev)
    frames = torch.arange(b, device=dev)
    u = torch.zeros((b, r), dtype=torch.float32, device=dev)
    v = torch.zeros((b, c), dtype=torch.float32, device=dev)
    row4col = torch.full((b, c), -1, dtype=torch.int64, device=dev)
    col4row = torch.full((b, r), -1, dtype=torch.int64, device=dev)
    scans = torch.zeros(b, dtype=torch.int64, device=dev)
    for cur_row in range(r):
        sink = torch.full((b,), -1, dtype=torch.int64, device=dev)
        i = torch.full((b,), cur_row, dtype=torch.int64, device=dev)
        min_val = torch.zeros(b, dtype=torch.float32, device=dev)
        spc = torch.full((b, c), float("inf"), device=dev)
        path = torch.full((b, c), -1, dtype=torch.int64, device=dev)
        sr = torch.zeros((b, r), dtype=torch.bool, device=dev)
        sc = torch.zeros((b, c), dtype=torch.bool, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        for _ in range(r):
            live = ~done[:, None]
            sr = sr | ((rows == i[:, None]) & live)
            cand = ((min_val[:, None] + cost[frames, i])
                    - u[frames, i][:, None]) - v
            better = (cand < spc) & ~sc & live
            spc = torch.where(better, cand, spc)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(sc, inf, spc)
            j = masked.argmin(dim=1)
            new_min = masked[frames, j]
            sc = sc | ((cols == j[:, None]) & live)
            owner = row4col[frames, j]
            unassigned = owner < 0
            sink = torch.where(done, sink, torch.where(unassigned, j, -1))
            i = torch.where(done | unassigned, i, owner)
            min_val = torch.where(done, min_val, new_min)
            done = done | unassigned
        scans += sc.sum(dim=1)

        # dual updates
        u[:, cur_row] = u[:, cur_row] + min_val
        other = sr & (rows != cur_row)
        u = torch.where(other, (u + min_val[:, None])
                        - spc.gather(1, col4row.clamp(0, c - 1)), u)
        v = torch.where(sc, v - (min_val[:, None] - spc), v)

        # augment: walk the path back to cur_row, at most r edges
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        j = sink
        for _ in range(r):
            i = path[frames, j]
            live = ~done[:, None]
            row4col = torch.where(live & (cols == j[:, None]), i[:, None],
                                  row4col)
            next_j = col4row[frames, i]
            col4row = torch.where(live & (rows == i[:, None]), j[:, None],
                                  col4row)
            done = done | (i == cur_row)
            j = torch.where(done, j, next_j)
    out = col4row.to(torch.int32)
    if single:
        out, scans = out[0], scans[0]
    return (out, scans) if return_scans else out


def lap_cuda(cost, row_mask, col_mask):
    """Launch the CUDA solver over a batch.

    Takes float32 costs (B, R, C) with 1 <= R <= C, and bool masks (B, R)
    and (B, C), all contiguous on one CUDA device; the masked cost and the
    solver's state must fit in one block's shared memory (C up to about
    1600 at R = 32; V5 has 32 x 384).
    Returns col4row (B, R) int32.
    """
    device = cost.device
    if device.type != "cuda":
        raise ValueError(f"lap_cuda needs CUDA tensors, got {device}")
    if cost.dim() != 3:
        raise ValueError(f"cost must be (B, R, C), got {tuple(cost.shape)}")
    b, r, c = cost.shape
    if not 1 <= r <= c:
        raise ValueError(f"the solver needs 1 <= rows <= cols, got {r}x{c}")
    check = kernel_lib.check_operand
    check(cost, "cost", torch.float32, (b, r, c), device)
    check(row_mask, "row_mask", torch.bool, (b, r), device)
    check(col_mask, "col_mask", torch.bool, (b, c), device)
    out = torch.empty((b, r), dtype=torch.int32, device=device)
    with profiling.span("kernel.lap"):
        lib = kernel_lib.library()
        code = lib.lap_launch(cost.data_ptr(), row_mask.data_ptr(),
                              col_mask.data_ptr(), b, r, c, out.data_ptr(),
                              kernel_lib.stream_handle(device))
        kernel_lib.check(code, "lap_launch")
        kernel_lib.LAUNCHES["lap"] += 1
    return out


def lap(cost, row_mask=None, col_mask=None):
    """Exact min-cost assignment of (R, C) or (B, R, C) costs: the twin on
    a CPU tensor, the kernel on a CUDA tensor.  Masks are optional (all
    real).  Returns col4row, (R,) or (B, R) int32."""
    if cost.device.type == "cpu":
        return lap_plain(cost, row_mask, col_mask)
    cost, row_mask, col_mask, single = _batched(cost, row_mask, col_mask)
    out = lap_cuda(cost.to(torch.float32).contiguous(),
                   row_mask.contiguous(), col_mask.contiguous())
    return out[0] if single else out
