"""The port's PointPillars trainer over a mesh
(``models/pointpillars/train.py`` ``PillarsTrainer(..., mesh=...)``: the
frames over ``data``, replicated variables, the synced BatchNorms and the
global ``num_pos``) against the JAX package's ``PillarsTrainer`` on its
mesh, and the distillation runner (``pipelines/yolo_distill.py``) on two
CPU ranks over gloo, as ``torchrun --nproc-per-node 2`` runs it.

The ranks import no JAX (this module imports it inside the fixture that
computes the reference); one JAX step is compiled for the file.

Tolerances (each test's docstring says why): the PointPillars step at the
dry run's tiny config (``__graft_entry__.py:216-234``: a 32 x 32 grid,
two frames of 256 points) from JAX's initial variables, world 2 against
JAX on a (2, 1) mesh: ``num_pos`` exact, loss parts within 1e-4
relative, every gradient within 1e-4 of its tensor's largest, the
running statistics within 1e-5, the second step's loss within 1e-4
relative -- the limits ``tests/test_torch_pointpillars_train.py`` holds
the one-process step to.  The runner: its files and its evaluation line
exact.
"""

import functools
import os

import numpy as np
import pytest

import chip_smoke
from lidar_object_detection_tpu_torch.models import pointpillars as tpp
from lidar_object_detection_tpu_torch.parallel import distributed

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 300
TINY_GRID = dict(x_range=(0.0, 10.24), y_range=(-5.12, 5.12),
                 pillar_size=0.32)
TINY = dict(embed_dim=8, backbone_channels=(8, 16, 32),
            backbone_layers=(1, 1, 1), up_channels=8)


def pillars_batch(dp=2):
    """The dry run's frames (``__graft_entry__.py:227-233``), with one
    cluster of points inside each frame's GT box."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 10, (dp, 256, 4)).astype(np.float32)
    pts[..., 1] = rng.uniform(-5, 5, (dp, 256))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (dp, 256))
    pts[:, :48, 0] = rng.uniform(4.3, 5.7, (dp, 48))
    pts[:, :48, 1] = rng.uniform(-1.5, 1.5, (dp, 48))
    pts[:, :48, 2] = rng.uniform(-1.6, -0.4, (dp, 48))
    valid = np.ones((dp, 256), bool)
    valid[1, -20:] = False
    gt7 = np.zeros((dp, 4, 7), np.float32)
    gt7[:, 0] = [5.0, 0.0, -1.0, 1.6, 3.9, 1.5, 0.2]
    gt7[1, 1] = [2.0, 3.0, -1.0, 1.6, 3.9, 1.5, 1.4]
    gv = np.zeros((dp, 4), bool)
    gv[:, 0] = True
    gv[1, 1] = True
    return pts, valid, gt7, np.zeros((dp, 4), np.int32), gv


def flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = np.array(v)
    return out


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def rank_pillars_step(variables):
    """One step in the trainer's pieces at world 2, then a second
    ``train_step``: the whole batch's parts, the gradients, the running
    statistics after the first step, the second step's metrics."""
    from lidar_object_detection_tpu_torch.parallel import (
        collectives, make_mesh)

    cfg = tpp.PillarsConfig(grid=tpp.PillarGridConfig(**TINY_GRID), **TINY)
    tr = tpp.PillarsTrainer(cfg, device="cpu", mesh=make_mesh("cpu"))
    tr.model.load_state_dict(tpp.pillars_state_from_flax(variables),
                             strict=True)
    batch = pillars_batch()
    local = tr.local_batch(*tr.batch_tensors(*batch))
    parts = tr.loss(*local)
    grads = tr.gradients(parts["loss"])
    tr.update(grads)
    keys = ["loss", "cls", "box", "dir"]
    total = collectives.all_reduce_coalesced(
        [parts[k].detach() for k in keys], tr.data_group)
    out = {"parts": {k: float(v) for k, v in zip(keys, total)},
           "num_pos": float(parts["num_pos"]),
           "local_frames": int(local[0].shape[0]),
           "grads": flat(tpp.pillars_flax_from_state(grads)["params"]),
           "stats": flat(tpp.pillars_flax_from_state(
               tr.model.state_dict())["batch_stats"])}
    m = tr.train_step(*batch)
    out["step2"] = {k: float(v) for k, v in m.items()}
    return out


def rank_runner(argv):
    """The distillation runner's ``main`` on this rank, as torchrun starts
    it; returns how often this rank wrote a checkpoint."""
    from lidar_object_detection_tpu_torch.pipelines import yolo_distill

    saves = []
    original = yolo_distill.save_ckpt
    yolo_distill.save_ckpt = lambda *a, **k: (saves.append(a[3]),
                                              original(*a, **k))
    assert yolo_distill.main(argv) == 0
    return saves


# ---------------------------------------------------------------------------
# PointPillars against JAX's trainer on its mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pillars_case(tmp_path_factory):
    """Two steps of JAX's ``PillarsTrainer`` on a (2, 1) mesh (its jitted
    ``_train_step``, the AdamW chained after a pass-through that keeps
    the gradients, the frames over ``data`` as its ``train_step`` places
    them) and of the port at world 2, from JAX's initial variables."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lidar_object_detection_tpu.models import pointpillars as jpp
    from lidar_object_detection_tpu.models.pointpillars import (
        train as jtrain)
    from lidar_object_detection_tpu.parallel import make_mesh
    from lidar_object_detection_tpu.parallel.train import TrainState

    batch = pillars_batch()
    with jax.enable_x64(False):
        mesh = make_mesh(jax.devices()[:2])
        jcfg = jpp.PillarsConfig(grid=jpp.PillarGridConfig(**TINY_GRID),
                                 **TINY)
        jt = jpp.PillarsTrainer(jcfg, mesh, num_points=256)
        init = jax.tree_util.tree_map(np.asarray, jt.state.variables)
        capture = optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))
        tx = optax.chain(capture, jt.tx)
        step = jax.jit(functools.partial(jtrain._train_step,
                                         model=jt.model, tx=tx, cfg=jcfg))
        state = TrainState(variables=jt.state.variables,
                           opt_state=tx.init(jt.state.variables["params"]),
                           step=jnp.zeros((), jnp.int32))
        put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(
            mesh, P("data", *([None] * (np.ndim(a) - 1)))))
        jbatch = [put(a) for a in batch]
        state, m1 = step(state, *jbatch)
        ref = {"parts": {k: float(v) for k, v in m1.items()},
               "grads": flat(jax.tree_util.tree_map(
                   np.asarray, state.opt_state[0])),
               "stats": flat(jax.tree_util.tree_map(
                   np.asarray, state.variables["batch_stats"]))}
        _, m2 = step(state, *jbatch)
        ref["step2"] = float(m2["loss"])
    runs = distributed.spawn(
        "test_torch_scale_out_train:rank_pillars_step", 2, (init,),
        timeout=TIMEOUT, device="cpu", path=[HERE],
        workdir=str(tmp_path_factory.mktemp("pillars")))
    return {"ref": ref, "port": [r.value for r in runs]}


def test_pillars_step_loss_parts_and_num_pos_match_jax_mesh(pillars_case):
    """Each rank holds one frame; the global num_pos (summed over
    ``data``) equals JAX's, and the loss parts (every rank's shares
    summed) are within 1e-4 relative of JAX's."""
    ref = pillars_case["ref"]["parts"]
    assert ref["num_pos"] >= 4
    for res in pillars_case["port"]:
        assert res["local_frames"] == 1
        assert res["num_pos"] == ref["num_pos"]
        for key in ("loss", "cls", "box", "dir"):
            assert rel(res["parts"][key], ref[key]) <= 1e-4, key


def test_pillars_step_gradients_and_statistics_match_jax_mesh(pillars_case):
    """The global gradients (the shares' gradients summed over ``data``)
    within 1e-4 of each tensor's largest of JAX's, and the running
    statistics after the step -- of the pillar net's masked BatchNorm
    and the backbone's, over both frames -- within 1e-5."""
    ref = pillars_case["ref"]
    for res in pillars_case["port"]:
        assert res["grads"].keys() == ref["grads"].keys()
        for key, want in ref["grads"].items():
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(res["grads"][key], want, rtol=0,
                                       atol=1e-4 * scale, err_msg=key)
        assert res["stats"].keys() == ref["stats"].keys()
        for key, want in ref["stats"].items():
            np.testing.assert_allclose(res["stats"][key], want, rtol=0,
                                       atol=1e-5, err_msg=key)


def test_pillars_second_step_matches_jax_mesh(pillars_case):
    """``train_step``'s metrics: the second step's global loss within 1e-4
    relative of JAX's, the same on both ranks."""
    losses = {res["step2"]["loss"] for res in pillars_case["port"]}
    assert len(losses) == 1
    assert rel(losses.pop(), pillars_case["ref"]["step2"]) <= 1e-4


# ---------------------------------------------------------------------------
# the distillation runner under two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runner_tree(tmp_path_factory):
    """A KITTI-360 tree of the two committed camera frames, each scan
    built around three fixed car rectangles (``chip_smoke.make_scene``)."""
    cars = np.array([[420, 170, 620, 260], [700, 160, 860, 240],
                     [980, 175, 1180, 280]], np.float32)
    rng = np.random.default_rng(9)
    frames = []
    for b, path in enumerate(chip_smoke.FRAMES):
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, cars + 30 * b, np.ones(3, bool), num_points=20000,
            num_boxes=8, num_valid=5)
        frames.append((100 + b, path, points[pvalid], corners[bvalid]))
    root = tmp_path_factory.mktemp("runner")
    chip_smoke.write_kitti360_tree(str(root / "kitti360"), frames)
    return root


@pytest.fixture(scope="module")
def runner_runs(runner_tree):
    """The runner twice on two CPU ranks (``--steps 2``, EMA on), each run
    with its own checkpoint path and the shared label cache."""
    runs = []
    for run in ("first", "again"):
        ckpt = str(runner_tree / f"{run}.msgpack")
        argv = ["--dataset", str(runner_tree / "kitti360"), "--cache",
                str(runner_tree / "labels.npz"), "--ckpt", ckpt,
                "--steps", "2", "--ema-decay", "0.9", "--device", "cpu"]
        ranks = distributed.spawn(
            "test_torch_scale_out_train:rank_runner", 2, (argv,),
            timeout=TIMEOUT, device="cpu", path=[HERE],
            workdir=str(runner_tree / f"ranks_{run}"))
        runs.append((ckpt, ranks))
    return runs


def test_runner_writes_and_prints_from_rank_zero_only(runner_runs):
    """Rank 0 writes the checkpoint once (at the last step) and prints the
    label, training and evaluation lines; rank 1 writes and prints
    nothing."""
    import json

    for ckpt, (zero, one) in runner_runs:
        assert zero.value == [2] and one.value == []
        assert one.stdout == ""
        assert "[train] step 1/2" in zero.stdout
        assert f"[train] ckpt -> {ckpt} @ 2" in zero.stdout
        line = json.loads(zero.stdout.strip().splitlines()[-1])
        assert line["ckpt_step"] == 2
        for suffix in ("", ".opt", ".json"):
            assert os.path.exists(ckpt + suffix)


def test_runner_two_runs_write_the_same_bytes(runner_runs):
    """Two runs at world 2 write the same .msgpack, .opt and .json bytes
    and print the same evaluation line."""
    (a, ra), (b, rb) = runner_runs
    for suffix in ("", ".opt", ".json"):
        with open(a + suffix, "rb") as fa, open(b + suffix, "rb") as fb:
            assert fa.read() == fb.read(), suffix
    assert ra[0].stdout.splitlines()[-1] == rb[0].stdout.splitlines()[-1]


def test_runner_checkpoint_holds_the_whole_state(runner_runs):
    """The world-2 checkpoint is the whole model (every YOLO11n-seg
    variable, the EMA copy and AdamW's moments at count 2), readable by
    the one-card trainer."""
    from lidar_object_detection_tpu_torch.models.yolo.model import (
        YoloConfig)
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer
    from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
        read_flax_msgpack)

    ckpt = runner_runs[0][0]
    raw = read_flax_msgpack(ckpt)
    opt = read_flax_msgpack(ckpt + ".opt")["opt_state"]
    assert int(np.asarray(raw["step"])) == 2
    assert int(opt["0"]["count"]) == 2
    tr = YoloTrainer(YoloConfig(scale="n"), device="cpu", ema_decay=0.9)
    tr.load(raw["variables"], 2, raw["ema_variables"])
    tr.load_opt_state(opt)
    got = flat(tr.variables())
    assert got.keys() == flat(raw["variables"]).keys()
    for key, value in flat(raw["variables"]).items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
