"""``optax.adamw``'s arithmetic, its learning-rate schedule and its state's
checkpoint layout.

Counterpart of the optax calls of the JAX package's trainers
(``parallel/train.py:395`` and ``models/pointpillars/train.py``):
``optax.adamw(learning_rate, weight_decay)`` with a constant rate, with
``optax.warmup_cosine_decay_schedule`` or with
``optax.cosine_decay_schedule``.  ``torch.optim.AdamW`` orders its
operations otherwise, so :func:`adamw_update` writes optax's out.

The state is optax's tuple ``(ScaleByAdamState(count, mu, nu),
EmptyState(), <the rate's state>)``: the rate's state is
``ScaleByScheduleState(count)`` with a schedule and ``EmptyState()`` with a
constant.  :func:`adamw_state_dict` lays it out as flax's
``to_state_dict`` does (tuples as maps keyed "0", "1", ...; empty states
as empty maps), so that flax's ``from_state_dict`` reads it back into the
JAX trainer's state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the step count and the first and
    second moments, keyed by parameter name.  A schedule's
    ``ScaleByScheduleState`` counts the same updates, so ``count`` is its
    count too."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    @staticmethod
    def zeros(params: Dict[str, torch.Tensor]) -> "AdamWState":
        return AdamWState(
            count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState,
                 learning_rate: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> AdamWState:
    """One ``optax.adamw`` step, the parameters updated in place; returns
    the new state.  Per parameter, in optax's order:

        mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g^2 + b2 * nu
        u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        p = p + (-lr) * (u + wd * p)

    The bias corrections ``1 - b^t`` are taken in float64 and rounded to
    float32, as optax takes them under JAX's 64-bit mode.  With a schedule
    ``learning_rate`` is its value at the state's count before this update
    (:func:`rate_at`).
    """
    count = state.count + 1
    mu, nu = {}, {}
    first = next(iter(params.values()))
    # device tensors, so that the divisions below are IEEE divisions
    bc1 = torch.tensor(1 - b1 ** count, dtype=first.dtype,
                       device=first.device)
    bc2 = torch.tensor(1 - b2 ** count, dtype=first.dtype,
                       device=first.device)
    for name, p in params.items():
        g = grads[name]
        mu[name] = (1 - b1) * g + b1 * state.mu[name]
        nu[name] = (1 - b2) * (g * g) + b2 * state.nu[name]
        u = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2 + 0.0) + eps)
        u = u + weight_decay * p
        p.copy_(p + (-learning_rate) * u)
    return AdamWState(count=count, mu=mu, nu=nu)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1): a linear ramp
    from ``init_value`` to ``peak_value`` over ``warmup_steps`` counts, then
    a cosine from ``peak_value`` to ``end_value`` over the remaining
    ``decay_steps - warmup_steps``, held after.  The value at a count is
    taken in float64 on the host, in optax's operation order (as optax
    takes it under JAX's 64-bit mode; JAX's 32-bit mode differs by float32
    rounding), and rounded to float32 where the update scales by it."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(f"the cosine part needs positive steps, got "
                         f"decay_steps - warmup_steps = {cosine_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac ** 1 + peak_value
        c = min(float(count - warmup_steps), float(cosine_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1 - alpha) * cosine ** 1.0 + alpha)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1), as the JAX package's
    PointPillars runners call it: ``init_value`` times ``(1 - alpha) *
    0.5 * (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha``.
    Taken in float64 on the host in optax's operation order and rounded to
    float32 where the update scales by it (:func:`rate_at`), as optax
    takes it under JAX's 64-bit mode; the JAX runners run in 32-bit mode,
    where optax evaluates it in float32 and may differ in the last bit."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        c = min(float(count), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine ** 1.0 + alpha)

    return schedule


def rate_at(learning_rate: Union[float, Schedule], count: int) -> float:
    """The rate an update at ``count`` scales by: a constant as it is, a
    schedule's value rounded to float32 (optax's ``jnp.array(step_size,
    dtype=g.dtype)``)."""
    if callable(learning_rate):
        return float(np.float32(learning_rate(count)))
    return learning_rate


def adamw_state_dict(state: AdamWState, to_flax: Callable[[dict], dict],
                     schedule: bool) -> dict:
    """``state`` as flax's ``to_state_dict`` lays out ``optax.adamw``'s
    tuple: ``{"0": {count, mu, nu}, "1": {}, "2": {count} or {}}`` ("2"
    holds the schedule's count, empty for a constant rate), the moments in
    the Flax layout that ``to_flax`` gives a name-keyed tree, the counts
    int32."""
    count = np.array(state.count, np.int32)
    moments = {key: to_flax(tree) for key, tree in (("mu", state.mu),
                                                    ("nu", state.nu))}
    return {"0": {"count": count, **moments}, "1": {},
            "2": {"count": count.copy()} if schedule else {}}


def adamw_state_from_dict(tree: dict, from_flax: Callable[[dict], dict],
                          device) -> AdamWState:
    """The inverse of :func:`adamw_state_dict`: ``from_flax`` turns a
    Flax-layout moment tree into a name-keyed one of tensors, put on
    ``device``.  A schedule's count must equal Adam's."""
    adam = tree["0"]
    count = int(np.asarray(adam["count"]))
    if tree.get("2") and int(np.asarray(tree["2"]["count"])) != count:
        raise ValueError(f"the schedule's count {tree['2']['count']} is not "
                         f"the Adam count {count}")
    moments = {key: {k: v.to(device) for k, v in from_flax(adam[key]).items()}
               for key in ("mu", "nu")}
    return AdamWState(count=count, **moments)
