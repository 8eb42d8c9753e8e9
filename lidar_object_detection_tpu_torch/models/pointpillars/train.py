"""PointPillars training step: forward in train mode, loss, backward and
an AdamW update, one frame batch per step, on one card or data parallel
over a mesh.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/train.py``
(``PillarsTrainer``, ``_train_step``) and of the ``TrainState`` of
``lidar_object_detection_tpu/parallel/train.py:364-373``.  The JAX step is
one jitted program on a mesh; here it runs op by op on ``device`` (the
card by default), gradients by autograd as JAX's come from
``jax.value_and_grad``.

With a mesh (``PillarsTrainer(..., mesh=...)``) the step is JAX's on its
mesh: the frames split over ``data`` and the variables replicated
(JAX's ``P()``).  Each rank takes its rows of the global batch;
train-mode BatchNorm, the pillar net's masked one included, takes the
whole batch's statistics and the loss the whole batch's ``num_pos``
(:mod:`..common`), so each rank's loss is its share of the
global loss and the gradients are summed over ``data``; AdamW then runs
alike on every rank.  The SSD assigner launches ``rotated_iou_pairs``
once per rank a step, on the rank's frames.  With ``mesh=None`` the
trainer is the one-card trainer, unchanged.

The optimizer is :func:`..parallel.optim.adamw_update`, ``optax.adamw``'s
arithmetic written out, at a constant rate or at a schedule's value at the
update count (the JAX runners' ``optax.cosine_decay_schedule``,
:func:`..parallel.optim.cosine_decay_schedule`); ``torch.optim.AdamW``
orders its operations otherwise.  b1 = 0.9, b2 = 0.999, eps = 1e-8 added
after ``sqrt(nu_hat)``, bias correction, then the decoupled decay ``wd * p``
added to the update of every parameter (optax's ``mask=None``: biases and
BatchNorm scales too), then the update scaled by ``-lr`` and added.

``PillarsTrainer(..., dtype=torch.bfloat16)`` is JAX's trainer with
``dtype=jnp.bfloat16``: the network computes in bfloat16
(``PointPillars(cfg, dtype)``), the losses cast the heads to float32, and
the parameters, gradients, AdamW's moments and the BatchNorm statistics
stay float32.  The SSD assigner's IoU takes the float32 anchors and GTs
whatever the dtype.

A float32 step (the default) runs in full float32 (TF32 off,
``full_float32``), a bfloat16 one in ``mixed_precision``; the backward
runs in :func:`..common.repeatable` too (cuDNN's deterministic
algorithms, the caller's settings restored after it), so that a run on
the card gives the same bits each time.  The forward needs no flag: its
convolutions' algorithms repeat their bits as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import numpy as np
import torch

from lidar_object_detection_tpu_torch.models.common import (
    numerics, repeatable, split_batch)
from lidar_object_detection_tpu_torch.models.pointpillars.center import (
    starve_weights)
from lidar_object_detection_tpu_torch.models.pointpillars.decode import (
    anchor_grid)
from lidar_object_detection_tpu_torch.models.pointpillars.init import (
    initialize)
from lidar_object_detection_tpu_torch.models.pointpillars.loss import (
    pointpillars_loss)
from lidar_object_detection_tpu_torch.models.pointpillars.model import (
    PillarsConfig, PointPillars)
from lidar_object_detection_tpu_torch.models.pointpillars.weights import (
    pillars_flax_from_state, pillars_state_from_flax)
from lidar_object_detection_tpu_torch.parallel import collectives
from lidar_object_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS, data_sharding)
from lidar_object_detection_tpu_torch.parallel.optim import (
    AdamWState, Schedule, adamw_state_dict, adamw_state_from_dict,
    adamw_update, rate_at)


@dataclasses.dataclass
class TrainState:
    """The network (its parameters and BatchNorm statistics), the
    optimizer's state and the step count."""

    model: PointPillars
    opt_state: AdamWState
    step: int
    # the rate is a schedule: optax's state then carries its count
    schedule: bool = False

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def flax_tree(self):
        """``(variables, opt_state, step)`` as the JAX package's trainer
        holds them: the Flax ``{"params", "batch_stats"}`` tree and
        ``optax.adamw``'s state ``(ScaleByAdamState(count, mu, nu),
        EmptyState(), ScaleByScheduleState(count) or EmptyState())``, as
        flax's ``to_state_dict`` lays them out (tuples as maps keyed "0",
        "1", ...), numpy arrays."""
        variables = pillars_flax_from_state(self.model.state_dict())
        opt = adamw_state_dict(
            self.opt_state,
            lambda tree: pillars_flax_from_state(tree)["params"],
            schedule=self.schedule)
        return variables, opt, np.array(self.step, np.int32)


class PillarsTrainer:
    """One frame batch per :meth:`train_step` on ``device``.

    The network is initialized by :func:`.init.initialize` from ``seed``
    (the JAX trainer's ``PRNGKey(seed)`` draws cannot be reproduced), and
    the anchor grid is built once, on the device.  ``learning_rate`` is a
    float or a schedule of the update count.  The JAX trainer's
    ``num_points`` (the shape of its initialization) has no counterpart:
    the port's network takes any cloud size.  With a ``mesh`` a batch is
    the global batch, whose frames the ``data`` axis divides, and every
    rank calls :meth:`train_step` together.  ``dtype`` is the network's
    compute dtype, float32 or bfloat16 (the JAX trainer's ``dtype``);
    :meth:`apply` serves in it too, as JAX's ``apply`` does.
    """

    def __init__(self, cfg: PillarsConfig,
                 learning_rate: Union[float, Schedule] = 2e-3,
                 weight_decay: float = 1e-4, seed: int = 0, device="cuda",
                 mesh=None, dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.mesh = mesh
        self.data_group = None if mesh is None else mesh.get_group(DATA_AXIS)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.device = torch.device(device)
        model = initialize(PointPillars(cfg, dtype), seed).to(self.device)
        split_batch(model, self.data_group)
        self.state = TrainState(
            model=model, opt_state=AdamWState.zeros(
                dict(model.named_parameters())), step=0,
            schedule=callable(learning_rate))
        self.anchors = (anchor_grid(cfg, self.device).reshape(-1, 7)
                        if cfg.head == "ssd" else None)

    @property
    def model(self) -> PointPillars:
        return self.state.model

    def _put(self, a, dtype=None):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        t = t.to(self.device)
        return t if dtype is None else t.to(dtype)

    def batch_tensors(self, points, valid, gt_boxes7, gt_classes, gt_valid):
        """The step's operands on the device."""
        return (self._put(points, torch.float32), self._put(valid),
                self._put(gt_boxes7, torch.float32), self._put(gt_classes),
                self._put(gt_valid))

    def local_batch(self, *batch):
        """This rank's rows of a global batch (:meth:`batch_tensors`'s),
        split over ``data``; the batch itself without a mesh."""
        if self.mesh is None:
            return batch
        return tuple(data_sharding(self.mesh, t) for t in batch)

    def loss(self, points, valid, gt_boxes7, gt_classes, gt_valid):
        """The train-mode forward (BatchNorm statistics updated) and the
        loss dict, on device tensors; with a mesh, this rank's rows
        (:meth:`local_batch`) and its share of the global loss."""
        cfg = self.cfg
        gt_pw = None
        if cfg.head == "center" and cfg.starve_weight > 0:
            gt_pw = starve_weights(points, valid, gt_boxes7, gt_valid, cfg)
        self.model.train()
        out = self.model(points, valid, train=True)
        return pointpillars_loss(out, gt_boxes7, gt_classes, gt_valid, cfg,
                                 gt_pos_weight=gt_pw, anchors=self.anchors,
                                 group=self.data_group)

    def gradients(self, loss) -> Dict[str, torch.Tensor]:
        """The parameters' gradients; with a mesh, of the global loss:
        the shares' gradients summed over ``data`` in one all-reduce."""
        params = self.state.params()
        with numerics(self.dtype), repeatable():
            grads = torch.autograd.grad(loss, list(params.values()))
        if self.data_group is not None:
            grads = collectives.all_reduce_coalesced(grads, self.data_group)
        return dict(zip(params, grads))

    def rate(self) -> float:
        """The learning rate of the next update."""
        return rate_at(self.learning_rate, self.state.opt_state.count)

    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        self.state.opt_state = adamw_update(
            self.state.params(), grads, self.state.opt_state, self.rate(),
            self.weight_decay)
        self.state.step += 1

    def restore(self, tree: dict) -> None:
        """Take a full checkpoint's state tree, ``{"0": variables, "1":
        opt_state, "2": step}`` (:meth:`TrainState.flax_tree`'s, which the
        JAX surround runner and this port both write): the network, the
        AdamW state and the step.  As flax's ``from_bytes`` against the
        JAX trainer's state, it refuses a slim checkpoint (no "1"), and an
        optimizer state whose schedule count the trainer's rate does not
        match: a schedule's state has it, a constant rate's does not."""
        if "1" not in tree:
            raise ValueError(
                "the checkpoint has no optimizer state (a slim, "
                "inference-only export): it can be served, not resumed")
        opt = tree["1"]
        kind = lambda schedule: ("a schedule" if schedule
                                 else "a constant rate")
        if bool(opt.get("2")) != self.state.schedule:
            raise ValueError(
                f"the checkpoint's optimizer state was written at "
                f"{kind(opt.get('2'))}, this trainer runs at "
                f"{kind(self.state.schedule)}")
        self.model.load_state_dict(pillars_state_from_flax(tree["0"]),
                                   strict=True)
        self.state.opt_state = adamw_state_from_dict(
            opt, lambda moments: pillars_state_from_flax(
                {"params": moments}), self.device)
        self.state.step = int(np.asarray(tree["2"]))

    def train_step(self, points, valid, gt_boxes7, gt_classes,
                   gt_valid) -> Dict[str, Any]:
        """One step on a (global) batch (numpy arrays or tensors):
        returns the loss, cls, box, dir and num_pos of the batch before
        the update, as tensors on the device."""
        batch = self.local_batch(*self.batch_tensors(
            points, valid, gt_boxes7, gt_classes, gt_valid))
        losses = self.loss(*batch)
        self.update(self.gradients(losses["loss"]))
        metrics = {k: v.detach() for k, v in losses.items()}
        if self.data_group is not None:
            # num_pos is the global count already; the rest are shares
            keys = [k for k in metrics if k != "num_pos"]
            metrics.update(zip(keys, collectives.all_reduce_coalesced(
                [metrics[k] for k in keys], self.data_group)))
        return metrics

    @torch.no_grad()
    def apply(self, points, valid):
        """The eval-mode forward (running statistics) on a batch."""
        self.model.eval()
        return self.model(self._put(points, torch.float32),
                          self._put(valid))
