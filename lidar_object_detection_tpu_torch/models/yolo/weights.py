"""Flax variables <-> PyTorch state dict, ultralytics state dicts, and the
serving weight fold.

Counterpart of ``lidar_object_detection_tpu/models/yolo/weights.py``.  The
JAX package names its Flax modules so that each variable path translates
token by token into an ultralytics state-dict key:

  flax ``params/layer2/m0/cv1/conv/kernel``  <->  ``model.2.m.0.cv1.conv.weight``
  flax ``batch_stats/layer0/bn/mean``        <->  ``model.0.bn.running_mean``
  flax ``params/head/detect/cv3_0_0_0/dw/conv/kernel``
                                             <->  ``model.23.cv3.0.0.0.conv.weight``

Conv kernels go HWIO <-> OIHW; the Proto transposed-conv kernel keeps its
(in, out, 2, 2) layout, which is ``nn.ConvTranspose2d``'s own; BN scale /
bias are weight / bias and the running statistics buffers.

* :func:`from_flax_variables`: a Flax tree -> the port's state dict (its
  keys are ultralytics'); :func:`yolo_flax_from_state` is its inverse
  (the trainer's checkpoints).
* :func:`convert_state_dict`: an ultralytics state dict -> a Flax tree,
  as the JAX package's function of the same name fills its template, with
  this module's own copy of the mapping; :func:`flax_template` gives the
  template of a network configuration (the JAX package takes a Flax
  ``init``'s).  Detectors load the tree through
  :func:`from_flax_variables`, as they load a msgpack checkpoint.
* :func:`load_state_dict_file`: a raw state dict saved with ``torch.save``.
* :func:`fold_serving_variables` folds BatchNorm into the conv kernels and
  casts the tree for serving (bf16 on the card), as the JAX package's
  function of the same name does.
"""

from __future__ import annotations

import pickle
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


def _torch_key_to_flax_path(key: str, segment: bool) -> Tuple[str, ...]:
    """An ultralytics state-dict key -> its (collection, *path) in the Flax
    tree of ``Yolo11(YoloConfig(segment=segment))``: the inverse of
    :func:`_flax_path_to_torch_key` and the leaf names of
    :func:`_torch_entry`."""
    *stem, leaf = key.split(".")
    if len(stem) < 2 or stem[0] != "model" or not stem[1].isdigit():
        raise KeyError(f"not a YOLO11 state-dict key: {key}")
    index, rest = int(stem[1]), stem[2:]
    path = ["head" if index == HEAD_INDEX else f"layer{index}"]
    if index == HEAD_INDEX and rest and rest[0] in ("cv2", "cv3", "cv4"):
        n = 1
        while n < len(rest) and rest[n].isdigit():
            n += 1
        if segment and rest[0] != "cv4":
            path.append("detect")
        path.append("_".join(rest[:n]))
        if rest[0] == "cv3" and n == 4 and rest[3] == "0":
            path.append("dw")       # YOLO11's depthwise cv3 stages
        rest = rest[n:]
    for token in rest:
        if token.isdigit():
            path[-1] += token       # m.0 -> m0, ffn.1 -> ffn1
        else:
            path.append(token)
    if leaf in ("running_mean", "running_var"):
        return ("batch_stats", *path, leaf[len("running_"):])
    if leaf == "weight":
        leaf = "scale" if path[-1] == "bn" else "kernel"
    elif leaf != "bias":
        raise KeyError(f"unhandled leaf {leaf} of {key}")
    return ("params", *path, leaf)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _torch_key(stem: str, leaf: str, collection: str) -> str:
    """The state-dict key of a Flax leaf."""
    if collection == "batch_stats":
        return f"{stem}.running_{'mean' if leaf == 'mean' else 'var'}"
    names = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    if leaf not in names:
        raise KeyError(f"unhandled leaf {leaf} at {stem}")
    return f"{stem}.{names[leaf]}"


def flax_kernel_axes(key: str) -> Tuple[int, ...]:
    """The dims of the 4-D kernel ``key`` (a state-dict key) in the order
    of its Flax kernel's axes: OIHW -> HWIO, but the Proto's
    transposed-conv kernel, which the JAX package keeps in its (in, out,
    2, 2) layout."""
    if key.rsplit(".", 1)[0].endswith("upsample"):
        return (0, 1, 2, 3)
    return (2, 3, 1, 0)


def _torch_entry(stem: str, leaf: str, collection: str, value):
    t = _as_tensor(value)
    if leaf == "kernel" and not stem.endswith("upsample"):
        t = t.permute(3, 2, 0, 1).contiguous()      # HWIO -> OIHW
    # the Proto's transposed-conv kernel stays (in, out, 2, 2)
    return _torch_key(stem, leaf, collection), t


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


def _set(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _flax_leaf(value: np.ndarray, path) -> np.ndarray:
    """An ultralytics array in the Flax layout of the leaf at ``path``."""
    if path[-1] == "kernel" and path[-2] != "upsample":
        return np.transpose(value, (2, 3, 1, 0))      # OIHW -> HWIO
    return value


def yolo_flax_from_state(state_dict: Dict[str, torch.Tensor],
                         segment: bool = True) -> dict:
    """A :class:`models.yolo.model.Yolo11` state dict -> the Flax
    ``{"params", "batch_stats"}`` tree of numpy arrays, in the state
    dict's dtypes: the inverse of :func:`from_flax_variables`, bit for
    bit.  Every key must translate back to itself."""
    tree: dict = {}
    for key, value in state_dict.items():
        if "num_batches_tracked" in key:
            continue
        collection, *path = _torch_key_to_flax_path(key, segment)
        back = _torch_key(*_flax_path_to_torch_key(tuple(path)), collection)
        if back != key:
            raise KeyError(f"{key} maps to flax {'/'.join(path)}, which "
                           f"maps back to {back}")
        _set(tree, (collection, *path), np.ascontiguousarray(
            _flax_leaf(value.detach().cpu().numpy(), path)))
    return tree


def flax_template(cfg) -> dict:
    """The Flax tree of ``Yolo11(cfg)``, float32 numpy leaves of the Flax
    shapes (values of a random init), built from the port's module: the
    template :func:`convert_state_dict` fills.  Every path translates back
    to its own state-dict key."""
    from lidar_object_detection_tpu_torch.models.yolo.model import Yolo11

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sd = Yolo11(cfg).state_dict()
    return yolo_flax_from_state({k: v.float() for k, v in sd.items()},
                                cfg.segment)


def convert_state_dict(state_dict: Dict[str, np.ndarray],
                       variables: dict) -> dict:
    """Fill a Flax variables template with an ultralytics state dict.

    Args:
      state_dict: torch name -> array (numpy arrays or tensors).
      variables: the template (:func:`flax_template`, or any Flax tree of
        the network); shapes must match.

    Returns a new tree of numpy arrays in the template's dtypes.  Raises
    ValueError listing every unmapped or mismatched entry: the conversion
    is all or nothing, as in the JAX package.
    """
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
          else np.asarray(v) for k, v in state_dict.items()}
    used, problems, out = set(), [], {}
    # in the sorted order of a JAX tree's leaves, so that the problems are
    # listed as the JAX package lists them
    for (collection, *path), value in sorted(_flatten(variables),
                                             key=lambda kv: kv[0]):
        stem, leaf = _flax_path_to_torch_key(tuple(path))
        try:
            key = _torch_key(stem, leaf, collection)
        except KeyError as e:
            problems.append(str(e))
            continue
        if key not in sd:
            problems.append(f"missing in state dict: {key} (for flax "
                            f"{'/'.join([collection, *path])})")
            continue
        arr = _flax_leaf(sd[key], path)
        template = np.asarray(_to_f32(value)) if isinstance(
            value, torch.Tensor) else np.asarray(value)
        if arr.shape != template.shape:
            problems.append(f"shape mismatch {key}: torch {arr.shape} vs "
                            f"flax {template.shape}")
            continue
        used.add(key)
        _set(out, (collection, *path), np.ascontiguousarray(
            arr.astype(template.dtype)))
    leftovers = [k for k in sd if k not in used
                 and not k.startswith(f"model.{HEAD_INDEX}.dfl.")
                 and "num_batches_tracked" not in k]
    if leftovers:
        problems.append(f"unconsumed torch keys: {sorted(leftovers)[:10]}"
                        f" (+{max(0, len(leftovers) - 10)} more)")
    if problems:
        raise ValueError("weight conversion failed:\n  "
                         + "\n  ".join(problems[:40]))
    return out


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """A raw state dict saved with ``torch.save(sd, path)``, as float32
    numpy arrays.  It is read with ``weights_only=True``: a full
    ultralytics checkpoint pickles ultralytics classes, which only the
    ultralytics package can unpickle, so such a file raises with a message
    saying so (extract the state dict there and save it raw)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} is not a raw state dict: it pickles classes (a full "
            f"ultralytics checkpoint needs the ultralytics package to "
            f"unpickle; save torch.load(path)['model'].state_dict() with "
            f"torch.save where it is installed) ({e})") from None
    if not isinstance(obj, dict):
        raise ValueError(f"{path} does not contain a state dict")
    return {k: v.float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in obj.items()}


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
