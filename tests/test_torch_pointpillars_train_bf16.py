"""The port's bfloat16 mixed-precision PointPillars training
(``PillarsTrainer(..., dtype=torch.bfloat16)``: ``models/common.py``'s
compute-dtype layers, ``models/pointpillars/{model,center,train}.py``)
against the JAX package's Flax modules and ``_train_step`` with
``dtype=jnp.bfloat16``, on the same seeded numpy inputs at the TINY size
of ``tests/test_torch_pointpillars_train.py`` (a 64 x 64 pillar grid, two
frames of 3000 points, 8 GT slots).

The JAX side is compiled with ``xla_allow_excess_precision`` off: XLA
then keeps every bfloat16 rounding the Flax program states (by default
the pillar feature net's outputs were 0.906 bit-equal, 0.99989
strictly).  The bfloat16 step on a mesh is held in
``tests/test_torch_mesh_bf16.py``.

Module level (train mode, float32 parameters): the share of output
elements bit-equal to Flax's and the largest deviation in bfloat16 ulps
of the reference element, pinned from a measurement (``PINNED``), for the
pillar feature net (the Dense in bfloat16, the masked BatchNorm in
float32 returning bfloat16, the scatter in float32), a transposed
``ConvBN`` and the SSD head's biased convolutions.

Step level: three steps per head from JAX's bfloat16 ``PillarsTrainer``
initial variables, as the float32 ``test_training_step_matches_jax``:
step 1's loss parts and the losses of steps 2-3 within STEP_MULTIPLE of
JAX's bfloat16 drift from the float32 step (step 1's also within
STEP1_RTOL relative), the port's and JAX's drifts of one size (the port
really computes in bfloat16); the heads bfloat16, the running
statistics and moments float32.  Step 1's gradients are held by the
median tensor's deviation, not tensor by tensor: JAX sums a bfloat16
layer's bias gradient in bfloat16 (the SSD class bias's lands 0.74 of
its largest entry from float32 at this size), PyTorch's bfloat16 sum in
float32 (3e-4), and AdamW's first step takes the gradient's sign, so the
losses after step 1 carry that difference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.models import pointpillars as jpp
from lidar_object_detection_tpu.models.pointpillars import model as jmodel
from lidar_object_detection_tpu.models.pointpillars import (
    train as jtrain)
from lidar_object_detection_tpu.parallel.mesh import make_mesh
from lidar_object_detection_tpu.parallel.train import TrainState
from lidar_object_detection_tpu_torch.models import pointpillars as tpp
from lidar_object_detection_tpu_torch.models.common import (
    set_compute_dtype)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    model as tmodel)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    train as ttrain)

TINY_GRID = dict(x_range=(0.0, 20.48), y_range=(-10.24, 10.24),
                 pillar_size=0.32)
TINY = dict(embed_dim=16, backbone_channels=(16, 32, 64),
            backbone_layers=(1, 1, 1), up_channels=16)
B, G, P = 2, 8, 3000
BF16 = torch.bfloat16
# measured (CPU, strict compile): bit-equal share, largest ulps
PINNED = {"pfn": (0.9995, 1), "up_transposed": (0.999, 2),
          "ssd_head": (1.0, 0)}
# the port's bfloat16 step against JAX's, in units of JAX's bfloat16
# drift from the float32 step (each of step 1's loss parts, the losses of
# steps 2 and 3); the card's step is held to the CPU's by the same multiple
STEP_MULTIPLE = chip_smoke.BF16_STEP_MULTIPLE
# step 1's loss parts against JAX's, relative (measured: 5.6e-4 at most)
STEP1_RTOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two PyTorch threads for this file, the caller's count restored
    after it (six test workers share the machine's cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def jax_32_bit():
    """JAX in 32-bit mode, as its trainers run (the suite turns 64-bit
    mode on)."""
    with jax.enable_x64(False):
        yield


def strict_compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def ulp_stats(got, ref):
    """(share of elements bit-equal, largest deviation in bfloat16 ulps of
    the reference element): an element's ulp is 2^(e - 7) for a
    reference of exponent e (the smallest normal's for 0)."""
    g = got.detach().float().numpy().astype(np.float64)
    r = np.asarray(ref).astype(np.float32).astype(np.float64)
    assert g.shape == r.shape
    mag = np.maximum(np.abs(r), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((g == r).mean()), float((np.abs(g - r) / ulp).max())


def configs(head="ssd", **kw):
    kw = {**TINY, **kw}
    return (jpp.PillarsConfig(grid=jpp.PillarGridConfig(**TINY_GRID),
                              head=head, **kw),
            tpp.PillarsConfig(grid=tpp.PillarGridConfig(**TINY_GRID),
                              head=head, **kw))


def cloud(rng):
    """(B, P, 4) float32 points over the TINY grid, the last 200 of each
    frame invalid, and some out of the grid."""
    pts = np.stack([rng.uniform(-1, 21.5, (B, P)),
                    rng.uniform(-11, 11, (B, P)),
                    rng.uniform(-2.5, 0.5, (B, P)),
                    rng.uniform(0, 1, (B, P))], -1).astype(np.float32)
    valid = np.ones((B, P), bool)
    valid[:, -200:] = False
    return pts, valid


def perturb(tree, rng):
    """Scales, running variances and biases away from 1 and 0, so that
    every affine step rounds."""
    for key, value in tree.items():
        if isinstance(value, dict):
            perturb(value, rng)
        elif key in ("scale", "var"):
            tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key in ("bias", "mean"):
            tree[key] = rng.normal(0, 0.3, value.shape).astype(np.float32)


def port_module(module, variables, stem):
    """Load a Flax module's variables into the port's module through the
    whole network's converter, under the network's path ``stem``."""
    wrapped = {}
    for collection, tree in variables.items():
        node = wrapped.setdefault(collection, {})
        *parents, last = stem.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = tree
    sd = tpp.pillars_state_from_flax(wrapped)
    module.load_state_dict({k[len(stem) + 1:]: v for k, v in sd.items()},
                           strict=True)
    set_compute_dtype(module, BF16)
    return module


def flax_train(jmodule, variables, *args):
    """The Flax module in train mode (its statistics updated, where it
    has any), compiled strictly: its output as numpy."""
    def apply(v, *a):
        if "batch_stats" not in v:
            return jmodule.apply(v, *a)
        return jmodule.apply(v, *a, train=True, mutable=["batch_stats"])[0]
    return jax.tree_util.tree_map(np.asarray, strict_compile(
        apply, variables, *args)(variables, *args))


def init(jmodule, *args, train=None):
    kw = {} if train is None else {"train": train}
    return jax.tree_util.tree_map(np.asarray, jax.jit(functools.partial(
        jmodule.init, **kw))(jax.random.PRNGKey(3), *args))


def case_pfn():
    jcfg, tcfg = configs()
    rng = np.random.default_rng(5)
    pts, valid = cloud(rng)
    jm = jmodel.PillarFeatureNet(jcfg, dtype=jnp.bfloat16)
    v = init(jm, pts, valid, train=False)
    perturb(v, rng)
    ref = flax_train(jm, v, jnp.asarray(pts), jnp.asarray(valid))
    tm = port_module(tmodel.PillarFeatureNet(tcfg), v, "pfn")
    got = tm.train()(torch.from_numpy(pts), torch.from_numpy(valid),
                     train=True)
    # the scatter is float32 of bfloat16 values: compare them as bfloat16
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert torch.equal(got, got.to(BF16).float())
    return got.to(BF16), ref.astype(jnp.bfloat16)


def case_up_transposed():
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(0, 1, (2, 6, 8, 32)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    jm = jmodel.ConvBN(16, 2, 2, transpose=True, dtype=jnp.bfloat16)
    v = init(jm, x)
    perturb(v, rng)
    ref = flax_train(jm, v, x)
    tm = port_module(tmodel.ConvBN(32, 16, 2, 2, transpose=True), v,
                     "backbone.up1")
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(BF16)
    return tm(xt, train=True).permute(0, 2, 3, 1), ref


def case_ssd_head():
    jcfg, tcfg = configs()
    rng = np.random.default_rng(7)
    c = tcfg.up_channels * len(tcfg.backbone_channels)
    x = jnp.asarray(rng.normal(0, 1, (2, 8, 8, c)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    jm = jmodel.SSDHead(jcfg, dtype=jnp.bfloat16)
    v = init(jm, x)
    perturb(v, rng)
    ref = flax_train(jm, v, x)
    tm = port_module(tmodel.SSDHead(tcfg), v, "head")
    out = tm(torch.from_numpy(np.asarray(x.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(BF16))
    got = torch.cat([out[k].reshape(2, 8, 8, -1)
                     for k in ("cls", "box", "dir")], -1)
    return got, np.concatenate([ref[k].reshape(2, 8, 8, -1)
                                for k in ("cls", "box", "dir")], -1)


@pytest.mark.parametrize("name", ["pfn", "up_transposed", "ssd_head"])
def test_module_rounds_as_flax(name):
    """A PointPillars module in bfloat16 train mode against the Flax
    module with ``dtype=bfloat16``, from the same float32 variables: the
    bit-equal share and the largest deviation in ulps within PINNED (the
    pillar feature net: features cast, the Dense's product in bfloat16,
    the masked BatchNorm's statistics and normalization in float32 and
    its output bfloat16, ReLU, the scatter-max in float32; a transposed
    ConvBN; the SSD head's three biased 1 x 1 convolutions, the bias
    added after the product)."""
    got, ref = {"pfn": case_pfn, "up_transposed": case_up_transposed,
                "ssd_head": case_ssd_head}[name]()
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    share, ulps = ulp_stats(got, ref)
    print(f"{name}: {share:.5f} bit-equal, largest {ulps:.3g} ulps")
    assert share >= PINNED[name][0] and ulps <= PINNED[name][1], (
        share, ulps)


# ---------------------------------------------------------------------------
# three steps per head from JAX's initial variables
# ---------------------------------------------------------------------------

def gt_boxes(rng, anchors):
    """(B, G, 7) GT boxes and validity: per frame two anchors (IoU 1), two
    anchors shifted by a fraction of a cell, two cars of any yaw, two
    invalid slots (the float32 test's construction)."""
    gt = np.zeros((B, G, 7), np.float32)
    valid = np.zeros((B, G), bool)
    for b in range(B):
        cells = rng.choice(len(anchors) // 2, 4, replace=False)
        pick = anchors[2 * cells + rng.integers(0, 2, 4)].copy()
        pick[2:, 0] += rng.uniform(0.5, 0.9, 2).astype(np.float32)
        pick[2:, 1] += rng.uniform(-0.3, 0.3, 2).astype(np.float32)
        cars = np.stack([rng.uniform(2, 18, 2), rng.uniform(-8, 8, 2),
                         np.full(2, -1.0), rng.uniform(1.5, 2.0, 2),
                         rng.uniform(3.5, 4.8, 2), rng.uniform(1.4, 1.7, 2),
                         rng.uniform(-np.pi, np.pi, 2)], 1)
        gt[b, :6] = np.concatenate([pick, cars]).astype(np.float32)
        valid[b, :6] = True
    return gt, valid


def car_cloud(rng, gt, valid, per_box=300):
    """(B, P, 4) points on the GT boxes and over the grid; the last 200
    of each frame invalid."""
    pts = np.zeros((B, P, 4), np.float32)
    for b in range(B):
        chunks = []
        for x, y, z, w, l, h, yaw in gt[b][valid[b]]:
            u = rng.uniform(-0.5, 0.5, (per_box, 3))
            c, s = np.cos(yaw), np.sin(yaw)
            chunks.append(np.stack([x + u[:, 0] * l * c - u[:, 1] * w * s,
                                    y + u[:, 0] * l * s + u[:, 1] * w * c,
                                    z + u[:, 2] * h], 1))
        rest = P - sum(len(c) for c in chunks)
        chunks.append(np.stack([rng.uniform(0, 20.48, rest),
                                rng.uniform(-10.24, 10.24, rest),
                                rng.uniform(-2.5, 0.5, rest)], 1))
        pts[b, :, :3] = np.concatenate(chunks)[:P]
        pts[b, :, 3] = rng.uniform(0, 1, P)
    valid_pts = np.ones((B, P), bool)
    valid_pts[:, -200:] = False
    return pts, valid_pts


def _capture_grads():
    """An optax transformation that passes the gradients through and keeps
    them as its state, so that JAX's ``_train_step`` returns them."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def flat_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def median_deviation(got, ref):
    """The median over tensors of each tensor's largest deviation relative
    to its largest entry in ``ref`` (tensors whose largest entry is 0
    left out)."""
    return float(np.median([
        float(np.abs(got[k].astype(np.float64) - r).max())
        / float(np.abs(r).max()) for k, r in ref.items()
        if np.abs(r).max() > 0]))


def port_run(tcfg, init_vars, batch, dtype, monkeypatch):
    """Three port steps from ``init_vars``, the first in the trainer's
    pieces: (per-step metrics, step 1's heads, step 1's gradients as a
    flat Flax tree, the trainer)."""
    monkeypatch.setattr(ttrain, "initialize", lambda model, seed: (
        model.load_state_dict(tpp.pillars_state_from_flax(
            jax.tree_util.tree_map(np.asarray, init_vars)), strict=True),
        model)[1])
    trainer = ttrain.PillarsTrainer(tcfg, device="cpu", dtype=dtype)
    heads = {}
    forward = trainer.model.forward
    trainer.model.forward = lambda *a, **k: heads.setdefault(
        len(heads), forward(*a, **k))
    parts = trainer.loss(*trainer.batch_tensors(*batch))
    grads = trainer.gradients(parts["loss"])
    trainer.update(grads)
    metrics = [{k: float(v) for k, v in parts.items()}]
    metrics += [{k: float(v) for k, v in trainer.train_step(*batch).items()}
                for _ in range(2)]
    return (metrics, heads[0],
            flat_leaves(tpp.pillars_flax_from_state(grads)["params"]),
            trainer)


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_bf16_steps_match_jax(monkeypatch, head):
    """Three steps of JAX's bfloat16 ``_train_step`` (strict compile) and
    of the port's bfloat16 trainer from JAX's bfloat16 ``PillarsTrainer``
    initial variables, on the float32 test's batch (``assign_iou="aabb"``,
    as there): num_pos exact; each of step 1's loss parts and the losses
    of steps 2-3 within STEP_MULTIPLE of JAX's relative drift from the
    float32 run (the port's float32 run stands in for JAX's: the float32
    tests hold it there within 1e-4), step 1's also within STEP1_RTOL;
    the port's summed drift within a factor of three of JAX's; the median
    tensor's step-1 gradient deviation within STEP_MULTIPLE of JAX's
    drift (each tensor apart is not held: see the module's docstring);
    step 1's heads bfloat16; after the steps the variables and AdamW's
    moments float32 with JAX's tree."""
    jcfg, tcfg = configs(head, assign_iou="aabb")
    rng = np.random.default_rng(21)
    gt, valid = gt_boxes(rng, tpp.anchor_grid(tcfg).reshape(-1, 7).numpy())
    pts, pv = car_cloud(rng, gt, valid)
    cls = np.zeros((B, G), np.int32)
    batch = (pts, pv, gt, cls, valid)
    jtrainer = jpp.PillarsTrainer(jcfg, make_mesh(jax.devices()[:1]),
                                  num_points=P, dtype=jnp.bfloat16)
    init_vars = jtrainer.state.variables
    tx = optax.chain(_capture_grads(), jtrainer.tx)
    jstate = TrainState(variables=init_vars,
                        opt_state=tx.init(init_vars["params"]),
                        step=jnp.zeros((), jnp.int32))
    jbatch = [jnp.asarray(a) for a in batch]
    step = strict_compile(functools.partial(
        jtrain._train_step, model=jtrainer.model, tx=tx, cfg=jcfg),
        jstate, *jbatch)
    jhist = []
    for i in range(3):
        jstate, jm = step(jstate, *jbatch)
        jhist.append({k: float(v) for k, v in jm.items()})
        if i == 0:
            jgrads = flat_leaves(jax.tree_util.tree_map(
                np.asarray, jstate.opt_state[0]))
    thist, heads, tgrads, trainer = port_run(tcfg, init_vars, batch, BF16,
                                             monkeypatch)
    fhist, _, fgrads, _ = port_run(tcfg, init_vars, batch, torch.float32,
                                   monkeypatch)
    keys = [k for k in jhist[0] if k != "num_pos"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    drift = {"jax": 0.0, "port": 0.0}
    for i, (t, j, f) in enumerate(zip(thist, jhist, fhist)):
        assert t["num_pos"] == j["num_pos"] == f["num_pos"]
        for key in keys if i == 0 else ("loss",):
            err, jdrift = rel(t[key], j[key]), rel(j[key], f[key])
            print(f"{head} step {i + 1} {key}: JAX bf16 {j[key]:.6g}, port "
                  f"bf16 {t[key]:.6g}, port f32 {f[key]:.6g}; port - JAX "
                  f"{err:.3g}, drifts JAX {jdrift:.3g} port "
                  f"{rel(t[key], f[key]):.3g}")
            assert err <= STEP_MULTIPLE * jdrift, (i, key)
            assert i > 0 or err <= STEP1_RTOL, key
            if key == "loss":
                drift["jax"] += jdrift
                drift["port"] += rel(t[key], f[key])
    assert drift["jax"] / 3 <= drift["port"] <= 3 * drift["jax"], drift
    grad_err = median_deviation(tgrads, jgrads)
    grad_drift = median_deviation(jgrads, fgrads)
    print(f"{head} step 1 gradients, the median tensor's deviation: port - "
          f"JAX {grad_err:.3g}, JAX's drift from float32 {grad_drift:.3g}")
    assert grad_err <= STEP_MULTIPLE * grad_drift
    assert all(v.dtype == BF16 for v in heads.values())
    state = tpp.pillars_flax_from_state(trainer.model.state_dict())
    ref = jax.tree_util.tree_map(np.asarray, jstate.variables)
    opt = trainer.state.flax_tree()[1]
    jopt = jax.tree_util.tree_map(np.asarray, jstate.opt_state)
    pairs = [(state, ref), (opt["0"]["mu"], jopt[1][0].mu),
             (opt["0"]["nu"], jopt[1][0].nu)]
    for got, want in pairs:
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert flat_g.keys() == flat_w.keys()
        for path, value in flat_w.items():
            assert value.dtype == np.float32 == flat_g[path].dtype, path
