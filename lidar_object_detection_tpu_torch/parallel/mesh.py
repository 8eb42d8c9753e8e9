"""The (data, model) device mesh of the scale-out layer.

Counterpart of ``lidar_object_detection_tpu/parallel/mesh.py``: a
``torch.distributed.device_mesh.DeviceMesh`` over the process group's
ranks, one card each, with two dims:

* ``data``  -- frames are independent, so a frame batch splits here (DP);
* ``model`` -- used two ways: the YOLO trainer's conv kernels are held in
  slices of their output axis here (:func:`.train.param_shardings`), and
  :func:`.sharding.point_sharded_fuse_frame` splits a scan's points here.

JAX places a global array on its mesh (``NamedSharding``).  The port has
no global array: :func:`data_sharding`, :func:`point_sharding` and
:func:`replicated` take the global tensor, which every rank holds, and
return this rank's part of it; they raise where JAX's placement would
not divide.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from lidar_object_detection_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(device_type: str = "cuda",
              model_parallel: int = 1) -> DeviceMesh:
    """A (world / model_parallel, model_parallel) mesh with dims named
    ("data", "model") over the process group's ranks, rank r at (r //
    model_parallel, r % model_parallel).

    With no process group up, a world of one comes up first
    (:func:`.distributed.initialize`), so that every sharded path also
    runs on one card: JAX's 1 x 1 mesh.
    """
    if not dist.is_initialized():
        distributed.initialize(device=device_type)
    n = dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def shard_rows(x: torch.Tensor, dim: int, parts: int, index: int,
               what: str = "axis") -> torch.Tensor:
    """The ``index``-th of ``parts`` equal slices of ``x`` along ``dim``;
    raises when they would not be equal."""
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"the {what} of size {size} does not divide into "
                         f"{parts} shards")
    k = size // parts
    return x.narrow(dim, index * k, k)


def data_sharding(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the leading (batch / frame) axis, split over
    ``data`` (JAX: ``P("data", None, ...)``)."""
    return shard_rows(x, 0, axis_size(mesh, DATA_AXIS),
                      mesh.get_local_rank(DATA_AXIS), "frame axis")


def replicated(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` whole, as every rank holds it (JAX: ``P()``)."""
    return x


def point_sharding(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's part of a (B, P, ...) array: its rows of the frame axis
    over ``data`` and of the point axis over ``model`` (JAX:
    ``P("data", "model", None, ...)``)."""
    rows = data_sharding(mesh, x)
    return shard_rows(rows, 1, axis_size(mesh, MODEL_AXIS),
                      mesh.get_local_rank(MODEL_AXIS), "point axis")
