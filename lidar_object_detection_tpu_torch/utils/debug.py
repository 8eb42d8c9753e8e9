"""Numerical-safety checks.

Counterpart of ``lidar_object_detection_tpu/utils/debug.py``:

* :func:`assert_finite` -- raise on NaN or Inf in a tree of tensors or
  arrays, naming the leaf by its path as ``jax.tree_util.keystr`` does;
* :func:`nan_guard` -- wrap a function so that every floating-point
  result of every operation it runs is checked for NaN (the counterpart of
  ``checkify_nan_guard``, which checks every primitive of a jitted
  function);
* :func:`coordinate_ranges` -- the reference's coordinate dump as data.

``jit_eager_parity`` has no counterpart: the port runs eagerly, and the
analogue of a jitted-against-eager check is each kernel's check against
its plain twin.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) in ``jax.tree_util``'s order: dict keys sorted,
    sequences in order; None is an empty subtree."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError if any floating-point leaf of ``tree`` (a
    tensor, array or number, or a dict, list or tuple of them) holds NaN
    or Inf."""
    for path, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            if not leaf.is_floating_point():
                continue
            bad = int((~torch.isfinite(leaf)).sum())
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            bad = int(np.size(arr) - np.isfinite(arr).sum())
        if bad:
            raise FloatingPointError(f"{name}{path}: {bad} non-finite values")


class _NanCheck(TorchDispatchMode):
    """Raises where an operation's floating-point output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for _, leaf in _leaves(out if isinstance(out, (list, tuple))
                               else [out]):
            if (torch.is_tensor(leaf) and leaf.is_floating_point()
                    and bool(torch.isnan(leaf).any())):
                raise FloatingPointError(f"nan generated by {func}")
        return out


def nan_guard(fn: Callable) -> Callable:
    """``fn`` with every operation it runs checked: the first that makes a
    NaN raises FloatingPointError naming it.  Each check reads a flag back
    from the device, so the guarded function runs synchronously: a
    debugging aid, not a serving path."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _NanCheck():
            return fn(*args, **kwargs)

    return wrapper


def coordinate_ranges(points, corners=None) -> Dict[str, Any]:
    """The reference's coordinate-system debug dump
    (``debug_coordinate_systems``, V5_ProjectingBBoxes.py:64-85) as data:
    min/max per axis for the cloud and optionally the first box."""
    pts = np.asarray(points)[:, :3]
    out = {"points": {ax: (float(pts[:, i].min()), float(pts[:, i].max()))
                      for i, ax in enumerate("xyz")}}
    if corners is not None and len(corners):
        c = np.asarray(corners)[0]
        out["bbox0"] = {ax: (float(c[:, i].min()), float(c[:, i].max()))
                        for i, ax in enumerate("xyz")}
    return out
