"""The port's PointPillars tools against the JAX package's example scripts,
on a synthetic KITTI-360 tree in ``tmp_path`` (``chip_smoke.
write_kitti360_tree``, its poses spread 12 m a frame so that a held-out
split has boxes outside every training frame's grid):

* the cosine schedule against optax's, and the scheduled optimizer state
  both ways between the packages (flax's ``from_bytes`` against the JAX
  trainer's template, ``PillarsTrainer.restore``), bit for bit;
* ``pipelines/pillars_surround.py`` against
  ``examples/train_pointpillars_surround.py``: both resume from one
  checkpoint written by flax (step 6 of 8, a cosine schedule, random
  moments) under ``--eval-frames=auto --protect-starved --cache``, for 2
  steps, one with GT-paste and one after the fade;
* ``pipelines/pillars_gate.py`` against ``examples/verify_pp_gate.py`` on
  the committed SSD checkpoint, on both sides of ``--min-recall``;
* ``pipelines/pillars_diagnose.py`` against
  ``examples/diagnose_pp_ckpt.py`` on the JAX runner's checkpoint;
* ``pointpillars-export`` against ``examples/export_pp_ckpt.py``;
* ``pipelines/pillars_overfit.py`` against
  ``examples/train_pointpillars_overfit.py``: 2 steps (one GT-pasted, one
  after the fade), the default grid replaced by a front grid of 64 x 64
  pillars: the batches and the evaluation batch, the JAX script's trainer
  replaced by a recorder (its step and evaluation are the surround
  runner's).

The JAX scripts are loaded with ``importlib`` and redirected only by
``monkeypatch``: ``Kitti360Dataset`` opens the tree, ``PillarsConfig.
kitti360_surround`` gives a +-10.24 m grid (16 x 16) in both packages,
and ``enable_compilation_cache`` does nothing; the runners and the
diagnosis run narrow layers (``TINY``, as the other PointPillars tests).
The committed checkpoint runs on that grid at its widths beside a sidecar
naming it.

Tolerances: batches, protected points, caches, split summaries, recall
strings and printed lines exact, but the GT boxes7 within 2e-5 (their
centres are float32 means of 8 corners, summed by XLA and torch.mean in
other orders: an ulp apart); losses within 1e-4 relative (the same
float32 step in two libraries); checkpoints read across within 1e-4 of
each tensor's largest entry (they are exact); the slim export byte for
byte.
"""

import dataclasses
import importlib.util
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import chip_smoke
from lidar_object_detection_tpu.data import kitti360 as jkitti
from lidar_object_detection_tpu.models import pointpillars as jpp_models
from lidar_object_detection_tpu.models.pointpillars import model as jmodel
from lidar_object_detection_tpu.models.pointpillars import train as jtrain
from lidar_object_detection_tpu.utils import cache as jcache
from lidar_object_detection_tpu_torch.models.pointpillars import (
    PillarGridConfig, PillarsConfig, boxes7_to_corners)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    train as ttrain)
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.parallel import optim
from lidar_object_detection_tpu_torch.pipelines import cli
from lidar_object_detection_tpu_torch.pipelines import (
    pillars_diagnose, pillars_gate, pillars_overfit, pillars_surround)
from lidar_object_detection_tpu_torch.pipelines import pointpillars as tpipe
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD_CKPT = os.path.join(REPO, "checkpoints", "pp_ssd_surround.msgpack")
# 16 x 16 pillars: 128 anchors, so the rotated-NMS decode's IoU matrix of
# its candidates is 128 x 128 (the JAX decode computes it op by op)
SMALL_GRID = dict(x_range=(-10.24, 10.24), y_range=(-10.24, 10.24),
                  z_range=(-5.0, 1.5), pillar_size=1.28)
# narrow layers: each JAX script compiles its own trainer, and the
# compiles are most of these tests' time
TINY = dict(embed_dim=16, backbone_channels=(16, 32, 64),
            backbone_layers=(1, 1, 1), up_channels=16)
FRAMES = (100, 101, 102, 103, 104)
# the resumed runs: step 6 of 8, the fade at step 7 (0.9 * 8)
RESUME_STEP, STEPS = 6, 8
RUN_FLAGS = ["--subsample=2048", "--eval-points=8192", "--fade=0.9",
             "--eval-frames=auto", "--protect-starved=64"]
FRONT_GRID = dict(x_range=(0.0, 10.24), y_range=(-5.12, 5.12),
                  z_range=(-3.0, 1.0), pillar_size=0.16)
OVERFIT_FLAGS = ["--subsample=2048", "--fade=0.5", "--frames=2"]
REL_TOL, TREE_TOL = 1e-4, 1e-4
# GT boxes7: their centres are float32 means of 8 corners, which XLA and
# torch.mean sum in other orders, an ulp apart
BOX_ATOL = 2e-5


def assert_same_batch(got, ref):
    """A step's (points, valid, gt boxes7, gt classes, gt valid): exact,
    but the boxes within BOX_ATOL."""
    for i, (b, a) in enumerate(zip(got, ref)):
        if i == 2:
            np.testing.assert_allclose(b, a, rtol=0, atol=BOX_ATOL)
        else:
            np.testing.assert_array_equal(b, a)


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scene(rng, k):
    """Frame k's velodyne points and its cars' boxes7: cars of 12 to 700
    points (the first two under the protection threshold), a ground plane
    and clutter out to 14 m."""
    cars = np.array([[3.0, 2.0, -1.0, 1.7, 4.2, 1.5, 0.3],
                     [-6.5, 5.0, -1.0, 1.8, 4.4, 1.6, 1.2],
                     [-5.0, -4.0, -1.0, 1.8, 4.5, 1.6, 1.6],
                     [6.0, -6.0, -0.9, 1.6, 3.9, 1.5, -0.8]], np.float32)
    cars[:, :2] += np.float32(0.3 * k)
    chunks = []
    for (x, y, z, w, l, h, yaw), n in zip(cars, (12, 40, 500, 700)):
        u = rng.uniform(-0.45, 0.45, (n, 3))
        c, s = np.cos(yaw), np.sin(yaw)
        chunks.append(np.stack([x + u[:, 0] * l * c - u[:, 1] * w * s,
                                y + u[:, 0] * l * s + u[:, 1] * w * c,
                                z + u[:, 2] * h], 1))
    ground = rng.uniform(-14, 14, (2000, 2))
    chunks.append(np.concatenate([ground, np.full((2000, 1), -1.75)], 1))
    chunks.append(rng.uniform([-14, -14, -3], [14, 14, 2], (400, 3)))
    xyz = np.concatenate(chunks).astype(np.float32)
    pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1))], 1)
    boxes = cars.copy()
    boxes[:, 3:6] *= np.float32(1.1)
    return pts.astype(np.float32), boxes


def write_tree(root, frames=FRAMES, seed=3, spread=8.0):
    """A tree of ``frames`` (``scene``), the ego's steps of
    ``chip_smoke.ego_pose`` made ``spread`` times longer."""
    rng = np.random.default_rng(seed)
    out = []
    for k, fid in enumerate(frames):
        pts, boxes = scene(rng, k)
        corners = boxes7_to_corners(torch.from_numpy(boxes)).numpy()
        cam = (corners @ chip_smoke.VELO_TO_RECT[:3, :3].T
               + chip_smoke.VELO_TO_RECT[:3, 3])
        out.append((fid, None, pts, cam.astype(np.float32)))
    chip_smoke.write_kitti360_tree(root, out)
    poses = os.path.join(root, "data_poses", "2013_05_28_drive_0000_sync")
    fmt = lambda a: " ".join(repr(float(x)) for x in np.ravel(a))
    spread_pose = []
    for k, fid in enumerate(frames):
        pose = chip_smoke.ego_pose(k)
        pose[:3, 3] *= spread
        spread_pose.append((fid, pose))
    with open(os.path.join(poses, "cam0_to_world.txt"), "w") as f:
        f.writelines(f"{i} {fmt(p)}\n" for i, p in spread_pose)
    with open(os.path.join(poses, "poses.txt"), "w") as f:
        f.writelines(f"{i} {fmt(p[:3])}\n" for i, p in spread_pose)
    return root


def small_configs(tiny=True):
    """The small grid in both packages, at the TINY widths (the layers of
    the committed checkpoints at ``tiny=False``)."""
    widths = TINY if tiny else {}
    return (jmodel.PillarsConfig(grid=jmodel.PillarGridConfig(**SMALL_GRID),
                                 **widths),
            PillarsConfig(grid=PillarGridConfig(**SMALL_GRID), **widths))


def redirect(monkeypatch, tree, tiny=True):
    """Point both packages' surround preset at ``small_configs(tiny)`` and
    the JAX scripts' dataset at ``tree``; no compilation cache."""
    jcfg, tcfg = small_configs(tiny)
    monkeypatch.setattr(jmodel.PillarsConfig, "kitti360_surround",
                        staticmethod(lambda: jcfg))
    monkeypatch.setattr(PillarsConfig, "kitti360_surround",
                        staticmethod(lambda: tcfg))
    real = jkitti.Kitti360Dataset
    monkeypatch.setattr(jkitti, "Kitti360Dataset",
                        lambda root, **kw: real(tree, **kw))
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda: None)


def _numpy(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def assert_trees_close(got, ref, what):
    """Same leaves; each within TREE_TOL of its largest entry (integer
    leaves exact)."""
    got_l = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    ref_l = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert got_l.keys() == ref_l.keys(), what
    for path, r in ref_l.items():
        r, g = np.asarray(r), np.asarray(got_l[path])
        assert g.shape == r.shape and g.dtype == r.dtype, (what, path)
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=f"{what} {path}")
            continue
        scale = float(np.abs(r).max()) if r.size else 0.0
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=TREE_TOL * max(scale, 1e-12),
                                   err_msg=f"{what} {path}")


def jax_state_template(variables, schedule):
    """``(variables, opt_state, step)`` as the JAX runner's trainer holds
    them, ``optax.adamw(schedule, weight_decay=1e-4)`` over ``variables``'
    params (``PillarsTrainer``'s optimizer)."""
    tx = optax.adamw(schedule, weight_decay=1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return (jax.tree_util.tree_map(jnp.asarray, variables),
            tx.init(params), jnp.zeros((), jnp.int32))


def scheduled_state(variables, count, seed=0):
    """The JAX state at ``count``: random moments (nu >= 0), both counts
    and the step at ``count``."""
    schedule = optax.cosine_decay_schedule(2e-3, STEPS, alpha=0.05)
    v, opt, _ = jax_state_template(variables, schedule)
    rng = np.random.default_rng(seed)
    draw = lambda x, scale: jnp.asarray(
        (rng.standard_normal(x.shape) * scale).astype(np.float32))
    adam = opt[0]._replace(
        count=jnp.int32(count),
        mu=jax.tree_util.tree_map(lambda x: draw(x, 1e-3), opt[0].mu),
        nu=jax.tree_util.tree_map(lambda x: jnp.abs(draw(x, 1e-6)),
                                  opt[0].nu))
    opt = (adam, opt[1], opt[2]._replace(count=jnp.int32(count)))
    return v, opt, jnp.int32(count)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("pp_runs_tree")))


@pytest.fixture(scope="module")
def init_variables():
    """The port's initial variables at the small grid, in Flax's layout."""
    _, tcfg = small_configs()
    return ttrain.PillarsTrainer(tcfg, device="cpu").state.flax_tree()[0]


# ---------------------------------------------------------------------------
# (a) the schedule and the scheduled state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.05])
def test_cosine_schedule_matches_optax(alpha):
    """``cosine_decay_schedule`` at counts 0, 1, N/2, N and N + 5, rounded
    to float32 as the update takes it, equals optax's (under x64, as the
    tests run JAX; the JAX runners run in 32-bit mode)."""
    n = 1000
    ref = optax.cosine_decay_schedule(2e-3, n, alpha=alpha)
    got = optim.cosine_decay_schedule(2e-3, n, alpha=alpha)
    for count in (0, 1, n // 2, n, n + 5):
        want = np.float32(ref(jnp.int32(count)))
        assert optim.rate_at(got, count) == want, count
    with pytest.raises(ValueError, match="positive decay_steps"):
        optim.cosine_decay_schedule(2e-3, 0)


def test_scheduled_state_round_trips_between_packages(init_variables,
                                                      tmp_path):
    """A scheduled state written by flax is restored by the port and
    written back bit for bit, and flax's ``from_bytes`` reads the port's
    file against the JAX template; a constant-rate trainer refuses the
    scheduled state, a scheduled one the constant state, and a slim
    checkpoint is refused for resume."""
    _, tcfg = small_configs()
    state = scheduled_state(init_variables, RESUME_STEP)
    jax_file = str(tmp_path / "jax.msgpack")
    with open(jax_file, "wb") as f:
        f.write(serialization.to_bytes(state))
    with open(jax_file + ".json", "w") as f:
        json.dump(tpipe.pillars_config_meta(tcfg), f)
    trainer = ttrain.PillarsTrainer(
        tcfg, learning_rate=optim.cosine_decay_schedule(2e-3, STEPS,
                                                        alpha=0.05),
        device="cpu")
    assert tpipe.restore_pillars_checkpoint(jax_file, trainer) == RESUME_STEP
    assert trainer.state.opt_state.count == RESUME_STEP
    port_file = str(tmp_path / "port.msgpack")
    tpipe.write_pillars_checkpoint(port_file, trainer, tcfg)
    with open(port_file, "rb") as f:
        port_bytes = f.read()
    with open(jax_file, "rb") as f:
        assert port_bytes == f.read()
    back = serialization.from_bytes(state, port_bytes)
    for got, ref in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # the rate of the next update is the schedule's at count 6
    assert trainer.rate() == np.float32(
        optax.cosine_decay_schedule(2e-3, STEPS, alpha=0.05)(
            jnp.int32(RESUME_STEP)))

    constant = ttrain.PillarsTrainer(tcfg, device="cpu")
    with pytest.raises(ValueError, match="written at a schedule"):
        constant.restore(read_flax_msgpack(jax_file))
    # the JAX template of a constant rate refuses the scheduled state too
    const_tmpl = jax_state_template(init_variables, 2e-3)
    with pytest.raises(ValueError):
        serialization.from_bytes(const_tmpl, port_bytes)
    const_file = str(tmp_path / "const.msgpack")
    tpipe.write_pillars_checkpoint(const_file, constant, tcfg)
    assert read_flax_msgpack(const_file)["1"]["2"] == {}
    with pytest.raises(ValueError, match="written at a constant rate"):
        trainer.restore(read_flax_msgpack(const_file))
    slim = str(tmp_path / "slim.msgpack")
    tpipe.export_slim_checkpoint(port_file, slim)
    with pytest.raises(ValueError, match="can be served, not resumed"):
        tpipe.restore_pillars_checkpoint(slim, trainer)


# ---------------------------------------------------------------------------
# (b), (c) the surround runner, resumed
# ---------------------------------------------------------------------------

def _spy(monkeypatch, cls, record, to_numpy):
    real = cls.train_step

    def train_step(self, *batch):
        m = real(self, *batch)
        record.append(([np.array(to_numpy(a)) for a in batch],
                       float(m["loss"])))
        return m

    monkeypatch.setattr(cls, "train_step", train_step)


def _masked(text):
    """Printed lines without their host seconds and losses."""
    lines = []
    for line in text.splitlines():
        if line.startswith(("{", "DONE", "step ")):
            continue
        lines.append(re.sub(r"\(\d+s\)", "(-s)", line))
    return lines


@pytest.fixture(scope="module")
def runs(tree, init_variables, tmp_path_factory):
    """Both surround runners resumed from one flax-written checkpoint;
    their batches, losses, printed lines, reports, caches and
    checkpoints."""
    mp = pytest.MonkeyPatch()
    out = {}
    base = tmp_path_factory.mktemp("pp_runs")
    state = scheduled_state(init_variables, RESUME_STEP, seed=1)
    capture = _Capture()
    try:
        redirect(mp, tree)
        example = _load_example("train_pointpillars_surround")
        for side in ("jax", "port"):
            d = base / side
            d.mkdir()
            ckpt = str(d / "ckpt.msgpack")
            with open(ckpt, "wb") as f:
                f.write(serialization.to_bytes(state))
            with open(ckpt + ".json", "w") as f:
                json.dump(tpipe.pillars_config_meta(small_configs()[1]), f)
            record = []
            flags = RUN_FLAGS + [f"--cache={d / 'frames.npz'}",
                                 f"--ckpt={ckpt}"]
            report = str(d / "report.json")
            with capture:
                if side == "jax":
                    _spy(mp, jtrain.PillarsTrainer, record, np.asarray)
                    mp.setattr(sys, "argv", ["x", str(STEPS), report]
                               + flags)
                    example.main()
                else:
                    _spy(mp, ttrain.PillarsTrainer, record,
                         lambda a: a.cpu().numpy() if torch.is_tensor(a)
                         else a)
                    kernel_lib.reset_launches()
                    assert pillars_surround.main(
                        [str(STEPS), report, "--device=cpu",
                         f"--dataset={tree}"] + flags) == 0
            with open(report) as f:
                rep = json.load(f)
            with np.load(str(d / "frames.npz")) as z:
                cache = {k: z[k] for k in z.files}
            text = capture.text.replace(str(d), "<dir>")
            out[side] = dict(record=record, text=text, report=rep,
                             cache=cache, ckpt=ckpt, dir=str(d))
    finally:
        mp.undo()
    out["template"] = state
    return out


class _Capture:
    """Standard output of a block, as text (pytest's capsys is function
    scoped)."""

    def __enter__(self):
        import io
        self._buf, self._old = io.StringIO(), sys.stdout
        sys.stdout = self._buf
        return self

    def __exit__(self, *exc):
        sys.stdout = self._old
        self.text = self._buf.getvalue()


def test_surround_runner_resumes_as_jax(runs):
    """Both runners resume at step 6, draw the same batches (GT-paste,
    then global augmentation with the protected points; bit-equal but the
    GT boxes, within an ulp), reach losses within 1e-4 relative, print the
    same split, cache, protected-point and database lines, write the same
    cache arrays (the boxes within an ulp), and report the same recall
    and clean recall."""
    jax_r, port_r = runs["jax"], runs["port"]
    assert len(jax_r["record"]) == len(port_r["record"]) == STEPS - \
        RESUME_STEP
    for (jb, jl), (tb, tl) in zip(jax_r["record"], port_r["record"]):
        assert_same_batch(tb, jb)
        assert _rel(tl, jl) <= REL_TOL, (tl, jl)
    assert _masked(port_r["text"]) == _masked(jax_r["text"])
    assert f"resumed from <dir>/ckpt.msgpack at step {RESUME_STEP}" in \
        port_r["text"]
    (prot,) = [line for line in port_r["text"].splitlines()
               if line.startswith("protect-starved: ")]
    assert any(int(x.split("/")[0]) for x in prot.split(": ")[1].split(", "))
    assert jax_r["cache"].keys() == port_r["cache"].keys()
    for k, v in jax_r["cache"].items():
        if k.startswith("b"):
            np.testing.assert_allclose(port_r["cache"][k], v, rtol=0,
                                       atol=BOX_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(port_r["cache"][k], v, err_msg=k)
    jrep, trep = jax_r["report"], port_r["report"]
    assert trep["config"] == jrep["config"]
    (je,), (te,) = jrep["chunks"], trep["chunks"]
    assert te["step"] == je["step"] == STEPS
    for key in ("recall", "heldout_clean_recall"):
        assert te[key] == je[key], key
    for key in ("precision", "bev_ap_050"):
        assert te[key] == je[key], key
    for key in ("loss", "mean_loss"):
        assert _rel(te[key], je[key]) <= REL_TOL, key
    # the rotated-NMS decode ran on the CPU's twin: no kernel launched
    assert not any(kernel_lib.LAUNCHES.values())


def test_surround_split_summary_matches_jax(runs):
    """``--eval-frames=auto``: the split line and the report's summary
    are JAX's, with held-out boxes outside every training grid."""
    split = runs["jax"]["report"]["config"]["split"]
    assert runs["port"]["report"]["config"]["split"] == split
    assert len(split["eval"]) == 2 and split["train"]
    assert split["eval_gt_overlapped"] < split["eval_gt_total"]
    line = [x for x in runs["port"]["text"].splitlines()
            if x.startswith("split: ")]
    assert line == [f"split: {json.dumps(split)}"]


def test_runner_checkpoints_read_across(runs):
    """Each runner's checkpoint is read by the other package: the port
    restores JAX's and holds its tensors, flax reads the port's against
    the JAX template and gets the port's, each within TREE_TOL of its
    largest entry (they are bit for bit); both files have one layout,
    step 8 and both counts at 8, and equal sidecars.  The two runs'
    trained values are not compared here: after two Adam steps from one
    state their moments differ by percents of a tensor's largest entry, as
    one step's gradients of this float32 network do from one batch
    (``tests/test_torch_pointpillars_train.py`` holds the step where it is
    well conditioned); the losses are held above."""
    _, tcfg = small_configs()
    jfile, tfile = runs["jax"]["ckpt"], runs["port"]["ckpt"]
    trainer = ttrain.PillarsTrainer(
        tcfg, learning_rate=optim.cosine_decay_schedule(2e-3, STEPS,
                                                        alpha=0.05),
        device="cpu")
    assert tpipe.restore_pillars_checkpoint(jfile, trainer) == STEPS
    v, o, s = trainer.state.flax_tree()
    jax_tree = read_flax_msgpack(jfile)
    assert_trees_close({"0": v, "1": o, "2": s}, jax_tree,
                       "port's restore of JAX's checkpoint")
    with open(tfile, "rb") as f:
        got = serialization.from_bytes(runs["template"], f.read())
    port_tree = read_flax_msgpack(tfile)
    assert_trees_close(serialization.to_state_dict(got), port_tree,
                       "flax's read of the port's checkpoint")
    shapes = lambda t: jax.tree_util.tree_map(
        lambda x: (np.shape(x), np.asarray(x).dtype.name), t)
    assert shapes(port_tree) == shapes(jax_tree)
    for tree in (port_tree, jax_tree):
        assert int(tree["2"]) == int(tree["1"]["0"]["count"]) == \
            int(tree["1"]["2"]["count"]) == STEPS
    with open(jfile + ".json") as a, open(tfile + ".json") as b:
        assert json.load(a) == json.load(b)


def test_surround_runner_center_head_without_augmentation(tree, tmp_path,
                                                          monkeypatch):
    """``--head=center --starve-weight=4 --no-augment`` on the CPU, from
    scratch: every batch frame is a subsample of a clean cached frame, its
    boxes the frame's as they are; the report names the head and weight,
    and no kernel is launched (the center head decodes without NMS)."""
    redirect(monkeypatch, tree)
    record = []
    _spy(monkeypatch, ttrain.PillarsTrainer, record, _numpy)
    report, cache = str(tmp_path / "r.json"), str(tmp_path / "f.npz")
    kernel_lib.reset_launches()
    with _Capture():
        assert pillars_surround.main(
            ["2", report, f"--dataset={tree}", "--device=cpu",
             "--head=center", "--starve-weight=4", "--no-augment",
             "--subsample=2048", "--eval-points=8192", "--frames=3",
             f"--cache={cache}"]) == 0
    rep = json.load(open(report))
    assert rep["config"]["head"] == "center"
    assert rep["config"]["starve_weight"] == 4.0
    (entry,) = rep["chunks"]
    assert entry["step"] == 2 and np.isfinite(entry["loss"])
    with np.load(cache) as z:
        frames = [(z[f"p{i}"], z[f"b{i}"]) for i in range(int(z["n"]))]
    for batch, _ in record:
        pts, pv, gt, _, gv = batch
        for j in range(len(pts)):
            boxes = gt[j][gv[j]]
            (i,) = [i for i, (_, b) in enumerate(frames)
                    if b.shape == boxes.shape and np.array_equal(b, boxes)]
            rows = {r.tobytes() for r in frames[i][0]}
            assert pv[j].sum() == min(2048, len(frames[i][0]))
            assert all(r.tobytes() in rows for r in pts[j][pv[j]])
    assert not any(kernel_lib.LAUNCHES.values())


def test_runner_refuses_without_dataset_or_card(monkeypatch):
    """No ``--dataset`` and no ``$LIDAR_TPU_KITTI360``: refused; on a
    machine without a card, ``--device cuda`` is refused (no fallback)."""
    monkeypatch.delenv("LIDAR_TPU_KITTI360", raising=False)
    with pytest.raises(SystemExit):
        pillars_surround.main(["8", "--device=cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            pillars_surround.main(["8", "--dataset=x"])


# ---------------------------------------------------------------------------
# (d) the gate, (e) the diagnosis, (f) the export
# ---------------------------------------------------------------------------

def test_gate_matches_jax_on_the_committed_checkpoint(tree, tmp_path,
                                                      monkeypatch, capsys):
    """``pillars_gate`` prints ``verify_pp_gate.py``'s lines for the
    committed SSD checkpoint and exits as it does (legacy mode, 2 frames):
    0 at ``--min-recall`` equal to the matched boxes, 1 one above; the
    held-out mode (``--eval-frames auto`` against those 2 frames) prints
    the split and the clean recall."""
    redirect(monkeypatch, tree, tiny=False)
    _, tcfg = small_configs(tiny=False)
    ckpt = str(tmp_path / "pp_ssd_surround.msgpack")
    os.symlink(SSD_CKPT, ckpt)
    with open(ckpt + ".json", "w") as f:
        json.dump(tpipe.pillars_config_meta(
            dataclasses.replace(tcfg, head="ssd")), f)
    monkeypatch.setenv("LIDAR_TPU_KITTI360", tree)
    example = _load_example("verify_pp_gate")
    flags = ["--frames", "2", "--max-points", "8192",
             "--score-threshold", "0.004"]

    def jax_run(args):
        monkeypatch.setattr(sys, "argv", ["x", ckpt, *flags, *args])
        try:
            example.main()
            code = 0
        except SystemExit as e:
            code = e.code
        return code, capsys.readouterr()

    code, ref = jax_run(["--min-recall", "0"])
    line = json.loads(ref.out.splitlines()[0])
    matched = int(line["recall"].split("/")[0])
    assert code == 0 and line["recall"].split("/")[1] != "0"
    for args, want in ((["--min-recall", str(matched)], 0),
                       (["--min-recall", str(matched + 1)], 1)):
        if args[1] != "0":
            code, ref = jax_run(args)
            assert code == want
        got = pillars_gate.main([ckpt, "--device", "cpu", *flags, *args])
        out = capsys.readouterr()
        assert got == want
        assert out.out == ref.out and out.err == ref.err
    # the held-out mode: the split against the 2 training frames (its
    # summary and clean recall are held to JAX's in the runner's tests)
    assert pillars_gate.main([ckpt, "--device", "cpu", *flags,
                              "--eval-frames", "auto",
                              "--min-recall", "0"]) == 0
    held = capsys.readouterr().out.splitlines()
    assert held[0].startswith("held-out eval [") and "vs train [100, 101]" \
        in held[0]
    line = json.loads(held[1])
    assert line["mode"] == "heldout" and line["train_frames"] == [100, 101]
    assert len(line["eval_frames"]) == 2 and "/" in line["clean_recall"]


def test_diagnosis_prints_jax_lines(runs, tree, tmp_path, monkeypatch,
                                    capsys):
    """``pillars_diagnose`` on the JAX runner's checkpoint and the first
    frame of its cache prints ``diagnose_pp_ckpt.py``'s lines: the step,
    the 3 x 3 grid of recalls and detections at ``max_detections=128``,
    and the per-GT table by distance."""
    cache = str(tmp_path / "one_frame.npz")
    full = runs["jax"]["cache"]
    np.savez(cache, n=np.int32(1), ids=full["ids"][:1], meta=full["meta"],
             p0=full["p0"], b0=full["b0"])
    redirect(monkeypatch, tree)
    flags = [f"--ckpt={runs['jax']['ckpt']}", f"--cache={cache}",
             "--eval-points=8192", "--subsample=2048"]
    example = _load_example("diagnose_pp_ckpt")
    monkeypatch.setattr(sys, "argv", ["x", *flags])
    example.main()
    ref = capsys.readouterr().out
    assert pillars_diagnose.main([*flags, "--device=cpu"]) == 0
    got = capsys.readouterr().out
    assert got == ref
    assert f"checkpoint step {STEPS}" in got and "per-GT analysis" in got


def test_slim_export_is_byte_equal_to_jax(runs, tmp_path, monkeypatch,
                                          capsys):
    """``pointpillars-export`` writes ``export_pp_ckpt.py``'s bytes and
    sidecar and prints its line; the slim file serves
    (``load_pillars_variables``)."""
    src = runs["jax"]["ckpt"]
    example = _load_example("export_pp_ckpt")
    ref, got = str(tmp_path / "ref.msgpack"), str(tmp_path / "got.msgpack")
    monkeypatch.setattr(sys, "argv", ["x", src, ref])
    example.main()
    ref_line = capsys.readouterr().out.replace(ref, got)
    assert cli.main(["pointpillars-export", src, got]) == 0
    assert capsys.readouterr().out == ref_line
    with open(ref, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    with open(ref + ".json") as a, open(got + ".json") as b:
        assert a.read() == b.read()
    _, tcfg = small_configs()
    _, step = tpipe.load_pillars_variables(got, expect_cfg=tcfg)
    assert step == STEPS and set(read_flax_msgpack(got)) == {"0", "2"}


# ---------------------------------------------------------------------------
# the overfit runner
# ---------------------------------------------------------------------------

class _Stop(Exception):
    """Ends the JAX overfit script at its evaluation."""


def test_overfit_runner_matches_jax(tree, tmp_path, monkeypatch):
    """The overfit runner, 2 steps (one GT-pasted, one after the fade) on
    a front grid of 64 x 64 pillars: the same batches and full-cloud
    evaluation batch as the JAX script's (bit-equal but the GT boxes,
    within an ulp), and a report in its layout.  The JAX script's trainer
    is replaced by one that records what it is given and ends the script
    at the evaluation: its step and evaluation are the surround runner's,
    held above."""
    redirect(monkeypatch, tree)
    tcfg = PillarsConfig(grid=PillarGridConfig(**FRONT_GRID), **TINY)
    example = _load_example("train_pointpillars_overfit")
    monkeypatch.setattr(pillars_overfit, "PillarsConfig", lambda: tcfg)
    got = {"jax": [], "port": []}

    class Recorder:
        def __init__(self, cfg, mesh, num_points, learning_rate):
            got["jax_num_points"] = num_points

        def train_step(self, *batch):
            got["jax"].append([np.array(a) for a in batch])
            return {"loss": np.float32(0.0)}

        def apply(self, points, valid):
            got["jax_eval"] = [np.array(points), np.array(valid)]
            raise _Stop

    monkeypatch.setattr(jpp_models, "PillarsTrainer", Recorder)
    monkeypatch.setattr(sys, "argv", ["x", "2", str(tmp_path / "j.json")]
                        + OVERFIT_FLAGS)
    with _Capture(), pytest.raises(_Stop):
        example.main()

    real_step, real_apply = (ttrain.PillarsTrainer.train_step,
                             ttrain.PillarsTrainer.apply)

    def train_step(self, *batch):
        got["port"].append([_numpy(a) for a in batch])
        return real_step(self, *batch)

    def apply(self, points, valid):
        got["port_eval"] = [_numpy(points), _numpy(valid)]
        return real_apply(self, points, valid)

    monkeypatch.setattr(ttrain.PillarsTrainer, "train_step", train_step)
    monkeypatch.setattr(ttrain.PillarsTrainer, "apply", apply)
    report = str(tmp_path / "t.json")
    kernel_lib.reset_launches()
    with _Capture():
        assert pillars_overfit.main(["2", report, "--device=cpu",
                                     f"--dataset={tree}"]
                                    + OVERFIT_FLAGS) == 0
    assert got["jax_num_points"] == 2048
    assert len(got["jax"]) == len(got["port"]) == 2
    for jb, tb in zip(got["jax"], got["port"]):
        assert_same_batch(tb, jb)
    for a, b in zip(got["jax_eval"], got["port_eval"]):
        np.testing.assert_array_equal(b, a)
    rep = json.load(open(report))
    assert rep["config"] == {"steps": 2, "subsample": 2048, "fade": 0.5,
                             "augment": True, "frames": 2, "lr_peak": 2e-3}
    (entry,) = rep["chunks"]
    assert set(entry) == {"step", "loss", "mean_loss", "recall",
                          "precision", "bev_ap_050", "elapsed_s"}
    assert entry["step"] == 2 and np.isfinite(entry["loss"])
    assert not any(kernel_lib.LAUNCHES.values())
