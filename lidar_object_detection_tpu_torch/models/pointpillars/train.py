"""PointPillars training step: forward in train mode, loss, backward and
an AdamW update, one frame batch per step.

Counterpart of ``lidar_object_detection_tpu/models/pointpillars/train.py``
(``PillarsTrainer``, ``_train_step``) and of the ``TrainState`` of
``lidar_object_detection_tpu/parallel/train.py:364-373``.  The JAX step is
one jitted program on a one-device mesh; here it runs op by op on
``device`` (the card by default), gradients by autograd as JAX's come from
``jax.value_and_grad``: no operation of the step has a custom backward.

The optimizer is :func:`..parallel.optim.adamw_update`, ``optax.adamw``'s
arithmetic written out (``torch.optim.AdamW`` orders its operations
otherwise): b1 = 0.9, b2 = 0.999, eps = 1e-8 added after
``sqrt(nu_hat)``, bias correction, then the decoupled decay ``wd * p``
added to the update of every parameter (optax's ``mask=None``: biases and
BatchNorm scales too), then the update scaled by ``-lr`` and added.

The step runs in full float32 (TF32 off, ``full_float32``); its backward
runs in :func:`..common.repeatable` (cuDNN's deterministic algorithms, the
caller's settings restored after it), so that a run on the card gives the
same bits each time.  The forward needs no flag: its convolutions'
algorithms repeat their bits as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from lidar_object_detection_tpu_torch.models.common import (
    full_float32, repeatable)
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
    pillars_flax_from_state)
from lidar_object_detection_tpu_torch.parallel.optim import (
    AdamWState, adamw_state_dict, adamw_update)


@dataclasses.dataclass
class TrainState:
    """The network (its parameters and BatchNorm statistics), the
    optimizer's state and the step count."""

    model: PointPillars
    opt_state: AdamWState
    step: int

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def flax_tree(self):
        """``(variables, opt_state, step)`` as the JAX package's trainer
        holds them: the Flax ``{"params", "batch_stats"}`` tree and
        ``optax.adamw``'s state ``(ScaleByAdamState(count, mu, nu),
        EmptyState(), EmptyState())``, as flax's ``to_state_dict`` lays
        them out (tuples as maps keyed "0", "1", ...), numpy arrays."""
        variables = pillars_flax_from_state(self.model.state_dict())
        opt = adamw_state_dict(
            self.opt_state,
            lambda tree: pillars_flax_from_state(tree)["params"],
            schedule=False)
        return variables, opt, np.array(self.step, np.int32)


class PillarsTrainer:
    """One frame batch per :meth:`train_step` on ``device``.

    The network is initialized by :func:`.init.initialize` from ``seed``
    (the JAX trainer's ``PRNGKey(seed)`` draws cannot be reproduced), and
    the anchor grid is built once, on the device.  The JAX trainer's
    ``num_points`` (the shape of its initialization) has no counterpart:
    the port's network takes any cloud size.
    """

    def __init__(self, cfg: PillarsConfig, learning_rate: float = 2e-3,
                 weight_decay: float = 1e-4, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.device = torch.device(device)
        model = initialize(PointPillars(cfg), seed).to(self.device)
        self.state = TrainState(
            model=model, opt_state=AdamWState.zeros(
                dict(model.named_parameters())), step=0)
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

    def loss(self, points, valid, gt_boxes7, gt_classes, gt_valid):
        """The train-mode forward (BatchNorm statistics updated) and the
        loss dict, on device tensors."""
        cfg = self.cfg
        gt_pw = None
        if cfg.head == "center" and cfg.starve_weight > 0:
            gt_pw = starve_weights(points, valid, gt_boxes7, gt_valid, cfg)
        self.model.train()
        out = self.model(points, valid, train=True)
        return pointpillars_loss(out, gt_boxes7, gt_classes, gt_valid, cfg,
                                 gt_pos_weight=gt_pw, anchors=self.anchors)

    def gradients(self, loss) -> Dict[str, torch.Tensor]:
        params = self.state.params()
        with full_float32(), repeatable():
            grads = torch.autograd.grad(loss, list(params.values()))
        return dict(zip(params, grads))

    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        self.state.opt_state = adamw_update(
            self.state.params(), grads, self.state.opt_state,
            self.learning_rate, self.weight_decay)
        self.state.step += 1

    def train_step(self, points, valid, gt_boxes7, gt_classes,
                   gt_valid) -> Dict[str, Any]:
        """One step on a batch (numpy arrays or tensors): returns the
        loss, cls, box, dir and num_pos of the batch before the update,
        as tensors on the device."""
        batch = self.batch_tensors(points, valid, gt_boxes7, gt_classes,
                                   gt_valid)
        losses = self.loss(*batch)
        self.update(self.gradients(losses["loss"]))
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def apply(self, points, valid):
        """The eval-mode forward (running statistics) on a batch."""
        self.model.eval()
        return self.model(self._put(points, torch.float32),
                          self._put(valid))
