"""The collectives of the scale-out layer, with the gradients JAX gives
them.

Under ``jax.jit`` a step on a sharded batch computes what the one-device
step computes: GSPMD inserts the reductions.  Here they are explicit:

* A training batch split over a group (the mesh's ``data`` axis) takes
  its statistics and normalisers over the whole batch through
  :mod:`..models.common` (``split_batch``, ``batch_mean``,
  ``batch_sum``, ``global_sum``), where the models' BatchNorm and losses
  reach them.  Each rank's loss is then its share of the whole batch's
  loss, and the trainers sum the gradients with
  :func:`all_reduce_coalesced`.
* :func:`psum` and :func:`pbroadcast` are JAX's pair for a value that
  every rank holds whole (a replicated loss): ``psum`` sums varying
  values into a replicated one and passes the replicated gradient back
  unchanged; ``pbroadcast`` makes a replicated value varying and sums the
  gradients of its uses (the transpose of each other).
* :func:`gather_shards` all-gathers sharded parameters for a forward; its
  backward keeps this rank's slice of each gradient.
* :func:`ring_shift` moves a tensor one rank along a group's ring (JAX's
  ``ppermute`` by +1); its backward is the shift by -1.
* :func:`all_reduce_coalesced` and :func:`all_gather_cat` are the
  gradient all-reduce (one collective for every tensor) and the gather of
  rows, with no gradient.

Every function takes its ``torch.distributed`` group.  Nothing here
copies a tensor to the host: the backend moves it (NCCL on the card, gloo
on the CPU, or gloo on the card for ranks that share one).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum the contiguous ``t`` over ``group`` in place (no gradient);
    returns it."""
    dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t``, concatenated along ``dim`` in the group's rank
    order (no gradient); bool tensors travel as bytes."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.detach().contiguous()
    if src.dtype == torch.bool:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    if t.dtype == torch.bool:
        parts = [p.view(torch.bool) for p in parts]
    return torch.cat(parts, dim=dim)


def all_reduce_coalesced(tensors: Sequence[torch.Tensor], group
                         ) -> List[torch.Tensor]:
    """The sum of each tensor over ``group``, in one all-reduce of their
    concatenation (tensors of one dtype and device); new tensors."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Pbroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``psum`` of varying values into a replicated one: the sum
    over ``group``; the gradient of a replicated result, which every rank
    holds whole, passes back unchanged."""
    return _Psum.apply(x, group)


def pbroadcast(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated value made varying (``psum``'s transpose): the value
    itself; the gradients of its uses on every rank are summed."""
    return _Pbroadcast.apply(x, group)


def _shift(t: torch.Tensor, group, step: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return t.clone()
    dst, src = (r + step) % n, (r - step) % n
    flat = t.contiguous().reshape(1, -1)
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, [int(q == src) for q in range(n)],
                           [int(q == dst) for q in range(n)], group=group)
    return out.reshape(t.shape)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad.contiguous(), ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i's ``x`` to rank i + 1 of ``group`` (the last to the first),
    by ``all_to_all_single``; the backward shifts the gradient back."""
    return _RingShift.apply(x, group)


def own_slice(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``full`` along ``dim``: the ``rank``-th of
    ``size`` equal slices."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = full.shape[dim] // n
    return full.narrow(dim, r * k, k)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dims, group, *shards):
        ctx.dims, ctx.group = dims, group
        flat = torch.cat([s.reshape(-1) for s in shards])
        parts = [torch.empty_like(flat)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, flat, group=group)
        out, start = [], 0
        for s, dim in zip(shards, dims):
            pieces = [p[start:start + s.numel()].view(s.shape)
                      for p in parts]
            out.append(torch.cat(pieces, dim=dim))
            start += s.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        # every rank of the group computed the same full gradient (the same
        # rows), so each keeps its own slice: no sum over the group
        return (None, None, *(None if g is None else own_slice(
            g, dim, ctx.group).contiguous()
            for g, dim in zip(grads, ctx.dims)))


def gather_shards(shards: Sequence[torch.Tensor], dims: Sequence[int],
                  group) -> List[torch.Tensor]:
    """The full tensors of parameters that ``group``'s ranks hold in
    slices along ``dims``, in one all-gather (one dtype and device); the
    backward keeps this rank's slice of each gradient, as every rank of
    the group sees the same rows."""
    if not shards:
        return []
    return list(_GatherShards.apply(tuple(dims), group, *shards))
