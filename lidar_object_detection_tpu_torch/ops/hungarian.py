"""Exact min-cost assignment: the dynamic shortest-augmenting-path solver.

Counterpart of ``lidar_object_detection_tpu/ops/hungarian.py``.  One
Dijkstra phase per row over the columns, each phase ending at the first
unassigned column it scans, then the dual update and the augmentation
along the path.  It is the oracle of :mod:`.lap` and serves V5's
``solver="exact"``; it is never on the serving path.

The loops are Python loops with the phase's exit read on the host, so a
phase costs one host round trip per scanned column: fine on the CPU, slow
on a card.  The arithmetic is JAX's, in float32 and in its order, and
ties go to the lowest index, as ``jnp.argmin`` breaks them.
"""

from __future__ import annotations

import torch

PAD_COST = 1.0e6


def masked_cost(cost, row_mask=None, col_mask=None) -> torch.Tensor:
    """(..., R, C) float32 costs with ``PAD_COST`` written into the masked
    rows and columns (R <= C)."""
    r, c = cost.shape[-2:]
    if r > c:
        raise ValueError(f"assignment needs rows <= cols, got {r}x{c}; "
                         "pad the column axis")
    cost = cost.to(torch.float32)
    pad = torch.tensor(PAD_COST, dtype=torch.float32, device=cost.device)
    if row_mask is not None:
        cost = torch.where(row_mask[..., :, None], cost, pad)
    if col_mask is not None:
        cost = torch.where(col_mask[..., None, :], cost, pad)
    return cost


def hungarian(cost, row_mask=None, col_mask=None) -> torch.Tensor:
    """Solve the min-cost assignment of (R, C) costs, R <= C, or of a
    batch (B, R, C) frame by frame.

    ``row_mask`` (R,) / ``col_mask`` (C,) (batched: (B, R) / (B, C))
    mark the real rows and columns; the others get ``PAD_COST``
    everywhere, so a padded pair never displaces a real one.  Returns
    col4row, (R,) or (B, R) int32.
    """
    if cost.dim() == 3:
        return torch.stack([
            hungarian(cost[b], None if row_mask is None else row_mask[b],
                      None if col_mask is None else col_mask[b])
            for b in range(cost.shape[0])])
    cost = masked_cost(cost, row_mask, col_mask)
    r, c = cost.shape
    dev = cost.device
    inf = torch.tensor(float("inf"), device=dev)
    u = torch.zeros(r, dtype=torch.float32, device=dev)
    v = torch.zeros(c, dtype=torch.float32, device=dev)
    row4col = [-1] * c
    col4row = [-1] * r
    for cur_row in range(r):
        spc = torch.full((c,), float("inf"), device=dev)
        path = torch.full((c,), -1, dtype=torch.int64, device=dev)
        sc = torch.zeros(c, dtype=torch.bool, device=dev)
        sr = [cur_row]
        i, min_val, sink = cur_row, torch.zeros((), device=dev), -1
        while sink < 0:
            cand = ((min_val + cost[i]) - u[i]) - v
            better = (cand < spc) & ~sc
            spc = torch.where(better, cand, spc)
            path = torch.where(better, i, path)
            masked = torch.where(sc, inf, spc)
            j = int(masked.argmin())
            min_val = masked[j]
            sc[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = row4col[j]
                sr.append(i)
        # dual updates
        u[cur_row] = u[cur_row] + min_val
        for row in set(sr) - {cur_row}:
            u[row] = (u[row] + min_val) - spc[col4row[row]]
        v = torch.where(sc, v - (min_val - spc), v)
        # augment along the alternating path back to cur_row
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            j, col4row[i] = col4row[i], j
            if i == cur_row:
                break
    return torch.tensor(col4row, dtype=torch.int32, device=dev)
