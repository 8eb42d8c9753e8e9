"""Flax variables -> PyTorch state dict, and the serving weight fold.

Counterpart of ``lidar_object_detection_tpu/models/yolo/weights.py``.  The
JAX package names its Flax modules so that each variable path translates
token by token into an ultralytics state-dict key; this module runs that
translation the other way:

  flax ``params/layer2/m0/cv1/conv/kernel``  ->  ``model.2.m.0.cv1.conv.weight``
  flax ``batch_stats/layer0/bn/mean``        ->  ``model.0.bn.running_mean``
  flax ``params/head/detect/cv3_0_0_0/dw/conv/kernel``
                                             ->  ``model.23.cv3.0.0.0.conv.weight``

Conv kernels go HWIO -> OIHW; the Proto transposed-conv kernel keeps its
(in, out, 2, 2) layout, which is ``nn.ConvTranspose2d``'s own; BN scale /
bias become weight / bias and the running statistics buffers.

:func:`fold_serving_variables` folds BatchNorm into the conv kernels and
casts the tree for serving (bf16 on the card), as the JAX package's
function of the same name does.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from lidar_object_detection_tpu_torch.models.yolo.model import HEAD_INDEX


def _flax_path_to_torch_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """A collection-less flax variable path -> (torch key stem, leaf)."""
    *mods, leaf = path
    tokens = []
    for seg in mods:
        if seg == "head":
            tokens.append(f"model.{HEAD_INDEX}")
        elif seg in ("detect", "dw"):
            continue   # flattened in torch (Segment is a Detect; DWConv a Conv)
        elif seg.startswith("layer"):
            tokens.append(f"model.{seg[5:]}")
        elif re.fullmatch(r"(cv\d|m)_?\d.*", seg) and "_" in seg:
            head, *idx = seg.split("_")
            tokens.append(".".join([head, *idx]))
        elif re.fullmatch(r"m\d+", seg):
            tokens.append(f"m.{seg[1:]}")
        elif seg in ("ffn0", "ffn1"):
            tokens.append(f"ffn.{seg[3]}")
        else:
            tokens.append(seg)
    return ".".join(tokens), leaf


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _torch_entry(stem: str, leaf: str, collection: str, value):
    t = _as_tensor(value)
    if collection == "batch_stats":
        return f"{stem}.running_{'mean' if leaf == 'mean' else 'var'}", t
    if leaf == "kernel":
        if stem.endswith("upsample"):
            return f"{stem}.weight", t                   # (in, out, 2, 2)
        return f"{stem}.weight", t.permute(3, 2, 0, 1).contiguous()
    if leaf == "scale":
        return f"{stem}.weight", t
    if leaf == "bias":
        return f"{stem}.bias", t
    raise KeyError(f"unhandled leaf {leaf} at {stem}")


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_flax_variables(variables) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` tree (numpy arrays or tensors)
    -> a state dict for :class:`models.yolo.model.Yolo11`."""
    sd: Dict[str, torch.Tensor] = {}
    for (collection, *path), value in _flatten(variables):
        stem, leaf = _flax_path_to_torch_key(tuple(path))
        key, tensor = _torch_entry(stem, leaf, collection, value)
        if key in sd:
            raise ValueError(f"two flax variables map to {key}")
        sd[key] = tensor
    return sd


def _to_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def fold_serving_variables(variables, dtype=torch.bfloat16,
                           eps: float = 1e-3):
    """Fold BatchNorm into the conv kernels and cast the tree to ``dtype``.

    Every ConvBNAct pair (a subtree with ``conv`` and ``bn`` children) gets
    ``w' = w * gamma / sqrt(var + eps)`` on the output-channel axis and
    ``b' = beta - mean * gamma / sqrt(var + eps)``, with the running stats
    set to the identity pair ``mean = 0, var = 1 - eps``.  The fold is done
    in float32 numpy, as in the JAX package; the result's leaves are
    tensors of ``dtype``.
    """
    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else _to_f32(v)
                for k, v in tree.items()}

    params = copy(variables["params"])
    stats = copy(variables.get("batch_stats", {}))

    def walk(p_node, s_node):
        for key, child in p_node.items():
            if not isinstance(child, dict):
                continue
            s_child = s_node.get(key, {}) if isinstance(s_node, dict) else {}
            if "conv" in child and "bn" in child and "bn" in s_child:
                gamma = child["bn"]["scale"]
                beta = child["bn"]["bias"]
                mean = s_child["bn"]["mean"]
                var = s_child["bn"]["var"]
                t = gamma / np.sqrt(var + np.float32(eps))
                child["conv"]["kernel"] = child["conv"]["kernel"] * t
                child["bn"]["scale"] = np.ones_like(gamma)
                child["bn"]["bias"] = beta - mean * t
                s_child["bn"]["mean"] = np.zeros_like(mean)
                s_child["bn"]["var"] = np.full_like(
                    var, np.float32(1.0) - np.float32(eps))
            walk(child, s_child)

    walk(params, stats)

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict)
                else torch.from_numpy(v).to(dtype) for k, v in tree.items()}

    out = {"params": cast(params)}
    if stats:
        out["batch_stats"] = cast(stats)
    return out
