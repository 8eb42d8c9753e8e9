"""The port's bfloat16 PointPillars step on a mesh
(``PillarsTrainer(..., mesh=..., dtype=torch.bfloat16)``) on two CPU ranks
over gloo, against the one-process bfloat16 trainer, which
``tests/test_torch_pointpillars_train_bf16.py`` holds to JAX's bfloat16
step.  The ranks import this module, so it imports no JAX.
"""

import os

import numpy as np
import torch

from lidar_object_detection_tpu_torch.models import pointpillars as tpp
from lidar_object_detection_tpu_torch.models.pointpillars import (
    train as ttrain)

BF16 = torch.bfloat16
# the bfloat16 mesh step's losses against the one-process step's,
# relative (read: 0 and 2.0e-4)
LOSS_RTOL = 2e-3


def flat(tree, path=()):
    """A nested dict of arrays as {"a/b/c": copy of the array}."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, (*path, key)))
        else:
            out["/".join((*path, key))] = np.array(value)
    return out


# the dry run's tiny network and grid (``__graft_entry__.py:216-234``), as
# ``tests/test_torch_scale_out_train.py`` runs it
MESH_GRID = dict(x_range=(0.0, 10.24), y_range=(-5.12, 5.12),
                 pillar_size=0.32)
MESH_TINY = dict(embed_dim=8, backbone_channels=(8, 16, 32),
                 backbone_layers=(1, 1, 1), up_channels=8)
LR = 2e-3   # PillarsTrainer's default rate


def mesh_batch():
    """Two frames of 256 points with a cluster inside each frame's GT box
    (``tests/test_torch_scale_out_train.py``'s ``pillars_batch``)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 10, (2, 256, 4)).astype(np.float32)
    pts[..., 1] = rng.uniform(-5, 5, (2, 256))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (2, 256))
    pts[:, :48, 0] = rng.uniform(4.3, 5.7, (2, 48))
    pts[:, :48, 1] = rng.uniform(-1.5, 1.5, (2, 48))
    pts[:, :48, 2] = rng.uniform(-1.6, -0.4, (2, 48))
    valid = np.ones((2, 256), bool)
    valid[1, -20:] = False
    gt7 = np.zeros((2, 4, 7), np.float32)
    gt7[:, 0] = [5.0, 0.0, -1.0, 1.6, 3.9, 1.5, 0.2]
    gt7[1, 1] = [2.0, 3.0, -1.0, 1.6, 3.9, 1.5, 1.4]
    gv = np.zeros((2, 4), bool)
    gv[:, 0] = True
    gv[1, 1] = True
    return pts, valid, gt7, np.zeros((2, 4), np.int32), gv


def mesh_steps(variables, mesh=None):
    """Two bfloat16 ``train_step`` calls of the tiny network from
    ``variables`` (a state dict), one-process or on ``mesh``: each
    step's metrics, and the variables after them (a flat numpy tree)."""
    cfg = tpp.PillarsConfig(grid=tpp.PillarGridConfig(**MESH_GRID),
                            **MESH_TINY)
    tr = ttrain.PillarsTrainer(cfg, device="cpu", mesh=mesh, dtype=BF16)
    tr.model.load_state_dict(variables, strict=True)
    metrics = [{k: float(v) for k, v in tr.train_step(*mesh_batch()).items()}
               for _ in range(2)]
    return metrics, flat(tpp.pillars_flax_from_state(tr.model.state_dict()))


def rank_bf16_mesh_steps(variables):
    """On each rank of a world of 2: ``mesh_steps`` on a (2, 1) mesh, one
    frame a rank."""
    from lidar_object_detection_tpu_torch.parallel import make_mesh

    return mesh_steps(variables, make_mesh("cpu"))


def test_bf16_mesh_step_matches_one_process(tmp_path):
    """``PillarsTrainer(..., mesh=..., dtype=bfloat16)`` at world 2 over
    gloo, one frame a rank (the whole batch's BatchNorm statistics and
    num_pos, the gradients summed over ``data``: JAX's step on its mesh),
    against the one-process bfloat16 trainer from the same seeded
    variables: num_pos exact, both steps' losses within LOSS_RTOL
    relative, the same on both ranks, and the variables after them
    float32: the parameters within 4 x LR (two Adam steps, each moving a
    parameter by at most the rate: where bfloat16 rounding turns a
    gradient's sign the two step apart) and the running statistics
    within 1e-2 of each tensor's largest entry (means of bfloat16
    activations, whose ulp is 2^-8 of their value)."""
    from lidar_object_detection_tpu_torch.parallel import distributed

    cfg = tpp.PillarsConfig(grid=tpp.PillarGridConfig(**MESH_GRID),
                            **MESH_TINY)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        variables = tpp.PointPillars(cfg).state_dict()
    ref, ref_vars = mesh_steps(variables)
    runs = distributed.spawn(
        "test_torch_mesh_bf16:rank_bf16_mesh_steps", 2,
        (variables,), timeout=300, device="cpu",
        path=[os.path.dirname(os.path.abspath(__file__))],
        workdir=str(tmp_path))
    for run in runs:
        metrics, got_vars = run.value
        for step, (got, want) in enumerate(zip(metrics, ref)):
            assert got["num_pos"] == want["num_pos"] >= 2, step
            err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            print(f"mesh step {step + 1}: loss {got['loss']:.6g}, one "
                  f"process {want['loss']:.6g} ({err:.3g} relative)")
            assert err <= LOSS_RTOL, step
        assert got_vars.keys() == ref_vars.keys()
        worst = {"params": 0.0, "batch_stats": 0.0}
        for key, want in ref_vars.items():
            assert got_vars[key].dtype == np.float32, key
            kind = key.split("/")[0]
            scale = (1.0 if kind == "params"
                     else max(float(np.abs(want).max()), 1e-12))
            worst[kind] = max(worst[kind], float(
                np.abs(got_vars[key] - want).max()) / scale)
        print(f"after two steps: parameters within {worst['params']:.3g} "
              f"(absolute), running statistics within "
              f"{worst['batch_stats']:.3g} of each tensor's largest entry")
        assert worst["params"] <= 4 * LR and worst["batch_stats"] <= 1e-2
    assert runs[0].value[0] == runs[1].value[0]
