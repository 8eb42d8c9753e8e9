"""GPipe-style pipeline parallelism over the ``model`` mesh axis.

Counterpart of ``lidar_object_detection_tpu/parallel/pipeline.py``: one
stage a ``model`` rank; micro-batches stream stage to stage around the
ring.  ``M`` micro-batches through ``S`` stages take ``M + S - 1`` ticks
(GPipe's bubble of ``(S - 1) / (M + S - 1)``):

  tick t:  every rank applies its stage to the micro-batch it holds
           (stage 0 takes micro-batch t, zeros once the input drains;
           ranks in the fill or drain bubble compute on zeros and the
           result is dropped, as JAX's does, rather than branch);
  then:    the last stage banks micro-batch t - S + 1 when it exists, and
           the states shift one stage forward (:func:`.collectives.
           ring_shift`, JAX's ``ppermute``).

Every rank runs the same operations (the stage's role is a tensor in a
``where``, as in JAX), so that the ranks' backward passes call their
collectives in the same order.

The last stage's outputs are replicated by :func:`.collectives.psum`, as
JAX's ``psum`` does.  Every step is differentiable with JAX's transposes
(the reverse shift, the replicated gradient of the ``psum``, the sum of
the stage parameters' and the input's gradients over the ranks through
:func:`.collectives.pbroadcast`), so ``torch.autograd`` through
:func:`pipeline_loss_fn` gives every rank the gradients of the
sequential chain: pipeline-parallel training, with the same bubble.

The chain is homogeneous: every stage maps a micro-batch to one of the
same shape, its parameters stacked on a leading S axis.
"""

from __future__ import annotations

from typing import Callable

import torch

from lidar_object_detection_tpu_torch.parallel import collectives
from lidar_object_detection_tpu_torch.parallel.mesh import (
    MODEL_AXIS, axis_size)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(mesh, stage_fn: Callable, stacked_params, x):
    """Run a homogeneous stage chain as a pipeline over ``model``.

    Args:
      mesh: a mesh whose ``model`` axis size S is the stage count.
      stage_fn: ``stage_fn(params_i, h) -> h`` for one stage, keeping the
        micro-batch's shape.
      stacked_params: a tree (dicts, lists, tuples) of tensors with a
        leading S axis, stage i's parameters at index i; the same on
        every rank.
      x: (M, mb, ...) micro-batched input, M >= 1, the same on every rank.

    Returns the (M, mb, ...) output of the whole chain on every rank.
    """
    group = mesh.get_group(MODEL_AXIS)
    s, stage = axis_size(mesh, MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS)
    m = x.shape[0]
    params = _tree_map(lambda a: collectives.pbroadcast(a, group)[stage],
                       stacked_params)
    xs = collectives.pbroadcast(x, group)
    # the stage's role as a tensor, not a branch: every rank then builds
    # the same graph, so that the backward's collectives pair up
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == s - 1, device=x.device)
    zero = torch.zeros_like(x[0])
    state = zero
    outs = [zero] * m
    for t in range(m + s - 1):
        inject = xs[t] if t < m else zero
        h = stage_fn(params, torch.where(first, inject, state))
        if t >= s - 1:
            outs[t - (s - 1)] = h      # banked; kept on the last stage only
        if t < m + s - 2:
            # the last tick's shift would carry nothing that is used
            state = collectives.ring_shift(h, group)
    out = torch.where(last, torch.stack(outs), torch.zeros_like(x))
    return collectives.psum(out, group)


def pipeline_loss_fn(mesh, stage_fn: Callable,
                     loss_fn: Callable) -> Callable:
    """:func:`pipeline_apply` wrapped into a scalar loss,
    ``fn(stacked_params, x, targets) = loss_fn(outputs, targets)``; every
    rank holds the same loss, and ``torch.autograd`` through it gives
    every rank the whole gradient of each stage's parameters."""
    def fn(stacked_params, x, targets):
        return loss_fn(pipeline_apply(mesh, stage_fn, stacked_params, x),
                       targets)
    return fn
