"""The port's YOLO11-seg training (``parallel/train.py``,
``parallel/optim.py``, ``models/yolo/init.py``, the train-mode BatchNorm
of ``models/common.py``, ``yolo_flax_from_state``)
and its distillation runner (``pipelines/yolo_distill.py``) against the JAX
package's trainer and ``examples/train_yolo_distill.py``, on the same seeded
numpy inputs.

Sizes: the n network at full width on (2, 64, 128) batches (168 anchors,
16 x 32 prototypes) for the step; the runner on a synthetic KITTI-360 tree
of two 376 x 1408 frames (the committed camera frames, with scans built
around the committed n checkpoint's detections), trained at the runner's
192 x 640.

Tolerances, stated per check (each test's docstring says why):
- train-mode ConvBNAct: outputs and updated running statistics within
  1e-5 (float32 statistics summed in another order);
- TAL: ``pos`` and ``assigned_gt`` exact, the data holding no decision
  within 1e-3 relative of its threshold; ``norm_align`` within 1e-5
  (``pow`` rounds differently in XLA and PyTorch);
- loss parts within 1e-5 relative, their gradients with respect to the
  raw outputs within 1e-5 of each output's largest gradient;
- the schedule: float64 values within 1e-12 relative of optax's under
  64-bit mode, and within 2e-6 of its 32-bit mode (float32 rounding of
  the intermediate values: 9 ulps at the warm-up's first count, where
  ``(init - peak) + peak`` cancels); AdamW
  under the schedule over 6 counts: parameters and moments within 1e-7;
- the EMA recurrence over 5 steps: bit for bit;
- one whole ``_train_step`` from the committed n variables: loss parts
  within 1e-4 relative; each gradient, updated BN statistic and AdamW
  moment within STEP_TOL = 1e-3 of its tensor's largest entry (a float32
  network summed in another order: 2.3e-4 at most), but the three
  gradients that are 0 but for rounding
  (``chip_smoke.YOLO_ZERO_GRAD_LEAVES``), each held on both sides within
  ``YOLO_ZERO_GRAD_SHARE`` = 1e-7 of the step's largest gradient
  (measured 2e-9 to 5e-9; the smallest other gradient that is not 0 is
  4e-6 of it), and their moments; the parameters' and the EMA's update,
  Adam's first step, ``-lr * g / (|g| + eps)`` (the gradient's sign),
  within 1e-3 of the rate of what the two gradients imply: where they
  differ in sign (fewer than 1e-3 of the parameters) the two step in
  opposite directions (``check_update``);
- the initializer: per-tensor standard deviation within 10 % of
  ``lecun_normal``'s, no value past two standard deviations, the same
  seed the same bits; the weight round trip: bit for bit;
- the runner: labels, checkpoint bytes, the resumed run's bytes and the
  evaluation's JSON line exact.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import chip_smoke
from lidar_object_detection_tpu.models.yolo import blocks as jblocks
from lidar_object_detection_tpu.models.yolo.model import (
    Yolo11 as JYolo11, YoloConfig as JYoloConfig)
from lidar_object_detection_tpu.parallel import train as jtrain
from lidar_object_detection_tpu_torch.models.yolo import blocks as tblocks
from lidar_object_detection_tpu_torch.models.yolo import init as tinit
from lidar_object_detection_tpu_torch.models.yolo.model import (
    Yolo11, YoloConfig)
from lidar_object_detection_tpu_torch.models.yolo.weights import (
    from_flax_variables, yolo_flax_from_state)
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.parallel import optim as toptim
from lidar_object_detection_tpu_torch.parallel import train as ttrain
from lidar_object_detection_tpu_torch.pipelines import yolo_distill as tdist
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack)
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "yolo11n_seg_distill.msgpack")
H, W = 64, 128
LEVELS = ((8, 16), (4, 8), (2, 4))
N_ANCHORS = 168
HP, WP = 16, 32
B, T = 2, 6
STEP_TOL = 1e-3
# the gradients that are 0 but for rounding (chip_smoke.YOLO_ZERO_GRAD_LEAVES)
# as flat() names them; their moments too
ZERO_LEAVES = {"".join(f"['{k}']" for k in path.split("/"))
               for path in chip_smoke.YOLO_ZERO_GRAD_LEAVES}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two PyTorch threads for this file, the caller's count restored
    after it.  The suite runs six workers on the machine's cores, and
    PyTorch's default of a thread per core oversubscribes them: its
    OpenMP threads then wait on each other, and this file's training
    steps at 192 x 640 ran a hundred times slower than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_close_scaled(got, ref, tol, what):
    """Every tensor of ``got`` within ``tol`` of its ``ref`` tensor's
    largest entry, but ZERO_LEAVES; returns the worst share."""
    got, ref = flat(got), flat(ref)
    assert got.keys() == ref.keys(), what
    worst = 0.0
    for key, r in ref.items():
        if key in ZERO_LEAVES:
            continue
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(got[key].astype(np.float64) - r).max()) / scale
        worst = max(worst, err)
        assert err <= tol, (what, key, err)
    return worst


def rel(a, b):
    a, b = (float(x.detach()) if torch.is_tensor(x) else float(x)
            for x in (a, b))
    return abs(a - b) / max(abs(b), 1e-12)


def targets_of(rng, b=B, t=T, h=H, w=W, valid_per_frame=4):
    """(B, T) GT boxes in letterbox pixels (sizes of a few cells on every
    level), classes from a few COCO ids, validity and {0, 1} masks at
    prototype resolution."""
    boxes = np.zeros((b, t, 4), np.float32)
    valid = np.zeros((b, t), bool)
    for i in range(b):
        for j in range(valid_per_frame):
            bw, bh = rng.uniform(10, 0.6 * w), rng.uniform(8, 0.7 * h)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes[i, j] = (x0, y0, x0 + bw, y0 + bh)
            valid[i, j] = True
    classes = rng.choice([2, 5, 7], (b, t)).astype(np.int32)
    masks = (rng.random((b, t, h // 4, w // 4)) > 0.4).astype(np.float32)
    return {"boxes": boxes, "classes": classes, "valid": valid,
            "masks": masks}


def jax_targets(tg):
    return {k: jnp.asarray(v) for k, v in tg.items()}


def torch_targets(tg):
    return {"boxes": torch.from_numpy(tg["boxes"]),
            "classes": torch.from_numpy(tg["classes"]).long(),
            "valid": torch.from_numpy(tg["valid"]),
            "masks": torch.from_numpy(tg["masks"])}


def crops(n=B):
    """(n, 64, 128, 3) float32 crops of the committed camera frame."""
    frame = read_png_rgb(chip_smoke.FRAMES[0]).astype(np.float32) / 255
    return np.stack([frame[180 + 40 * i:180 + 40 * i + H,
                           500 + 150 * i:500 + 150 * i + W]
                     for i in range(n)]).astype(np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_train_mode_batchnorm_matches_flax():
    """Train-mode ``ConvBNAct`` (a strided 3 x 3 convolution) against the
    JAX package's with ``mutable=["batch_stats"]``: outputs and the
    updated running statistics within 1e-5 (float32 statistics over 2 x
    16 x 16 pixels, summed in another order); eval mode afterwards uses
    the updated statistics; a module in eval mode leaves them alone."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 1.2, (2, 32, 32, 8)).astype(np.float32)
    jm = jblocks.ConvBNAct(12, 3, 2)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["params"]["bn"]["scale"] = rng.uniform(
        0.5, 1.5, 12).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = rng.uniform(
        0.5, 2.0, 12).astype(np.float32)
    ref, upd = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    tm = tblocks.ConvBNAct(8, 12, 3, 2)
    tm.load_state_dict(from_flax_variables(variables))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        before = tm.eval()(xt)
    assert torch.equal(tm.bn.running_var,
                       torch.from_numpy(variables["batch_stats"]["bn"]["var"]))
    got = tm.train()(xt)
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-5)
    for key, buf in (("mean", tm.bn.running_mean),
                     ("var", tm.bn.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(upd["batch_stats"]["bn"][key]),
                                   rtol=0, atol=1e-5)
    evald = jm.apply({"params": variables["params"], **upd}, jnp.asarray(x))
    with torch.no_grad():
        after = tm.eval()(xt)
    np.testing.assert_allclose(after.permute(0, 2, 3, 1).numpy(),
                               np.asarray(evald), rtol=0, atol=1e-5)
    assert not torch.allclose(before, after)


def assign_case(seed):
    """TAL operands: (B, N, 80) logits and (B, N, 4) predicted boxes
    around each anchor, and targets, as numpy float32."""
    rng = np.random.default_rng(seed)
    centers, strides = ttrain._anchor_centers(LEVELS)
    centers, strides = centers.numpy(), strides.numpy()
    logits = rng.normal(-2.0, 1.5, (B, N_ANCHORS, 80)).astype(np.float32)
    ltrb = rng.uniform(0.3, 4.0, (B, N_ANCHORS, 4)) * strides[:, None]
    pred = np.concatenate([centers - ltrb[..., :2],
                           centers + ltrb[..., 2:]], -1).astype(np.float32)
    return logits, pred, targets_of(rng)


def _margins(logits, pred, tg, topk=10):
    """The smallest relative gaps of TAL's decisions (k-th against
    (k+1)-th alignment of each GT, the best against the second claimant
    of each anchor), from the port's own alignment."""
    tb = torch.from_numpy(tg["boxes"])
    centers, _ = ttrain._anchor_centers(LEVELS)
    from lidar_object_detection_tpu_torch.geom.boxes import iou_2d_matrix
    iou = iou_2d_matrix(tb, torch.from_numpy(pred)).double()
    scores = torch.sigmoid(torch.from_numpy(logits).double())
    cls = torch.from_numpy(tg["classes"]).long()
    cls_t = torch.gather(scores, 2, cls[:, None, :].expand(
        B, N_ANCHORS, T)).transpose(1, 2)
    cx, cy = centers[:, 0].double(), centers[:, 1].double()
    tbd = tb.double()
    inside = ((cx >= tbd[..., 0, None]) & (cx <= tbd[..., 2, None])
              & (cy >= tbd[..., 1, None]) & (cy <= tbd[..., 3, None])
              & torch.from_numpy(tg["valid"])[..., None])
    align = torch.where(inside, cls_t ** 0.5 * iou.clamp(min=0) ** 6, 0.0)
    top = torch.sort(align, -1, descending=True).values
    kth, nxt = top[..., topk - 1], top[..., topk]
    gap_k = ((kth - nxt) / kth.clamp(min=1e-30))[kth > 0]
    two = torch.sort(align, 1, descending=True).values[:, :2]
    claimed = two[:, 1] > 0
    gap_a = ((two[:, 0] - two[:, 1]) / two[:, 0].clamp(min=1e-30))[claimed]
    return float(gap_k.min()), (float(gap_a.min()) if claimed.any()
                                else 1.0)


@pytest.mark.parametrize("seed", [3, 4])
def test_task_aligned_assign_matches_jax(seed):
    """``task_aligned_assign`` on the batch against the JAX function
    vmapped over frames: ``pos`` and ``assigned_gt`` exact, ``norm_align``
    within 1e-5 (XLA's ``pow`` and PyTorch's round differently); the data
    holds no TAL decision within 1e-3 relative of its threshold."""
    logits, pred, tg = assign_case(seed)
    gap_k, gap_a = _margins(logits, pred, tg)
    assert gap_k > 1e-3 and gap_a > 1e-3, (gap_k, gap_a)
    ref = jax.vmap(lambda cl, pb, tb, tc, tv: jtrain.task_aligned_assign(
        cl, pb, {"boxes": tb, "classes": tc, "valid": tv}, LEVELS))(
        jnp.asarray(logits), jnp.asarray(pred), *(
            jnp.asarray(tg[k]) for k in ("boxes", "classes", "valid")))
    tt = torch_targets(tg)
    got = ttrain.task_aligned_assign(
        torch.from_numpy(logits), torch.from_numpy(pred), tt["boxes"],
        tt["classes"], tt["valid"], LEVELS)
    pos = np.asarray(ref["pos"])
    assert pos.sum() >= 8
    np.testing.assert_array_equal(got["pos"].numpy(), pos)
    np.testing.assert_array_equal(got["assigned_gt"].numpy()[pos],
                                  np.asarray(ref["assigned_gt"])[pos])
    np.testing.assert_array_equal(got["assigned_gt"].numpy(),
                                  np.asarray(ref["assigned_gt"]))
    np.testing.assert_allclose(got["norm_align"].numpy(),
                               np.asarray(ref["norm_align"]), rtol=0,
                               atol=1e-5)


def test_task_aligned_assign_duplicate_gts_take_the_first():
    """Two GTs with the same box and class tie exactly on every anchor:
    the anchor goes to the first, as ``jnp.argmax`` gives it (the
    port's ``torch.argmax`` takes the first maximum too), on the batch
    against JAX's, ``pos`` and ``assigned_gt`` exact."""
    logits, pred, tg = assign_case(5)
    tg["boxes"][:, 1] = tg["boxes"][:, 0]
    tg["classes"][:, 1] = tg["classes"][:, 0]
    tt = torch_targets(tg)
    got = ttrain.task_aligned_assign(
        torch.from_numpy(logits), torch.from_numpy(pred), tt["boxes"],
        tt["classes"], tt["valid"], LEVELS)
    ref = jax.vmap(lambda cl, pb, tb, tc, tv: jtrain.task_aligned_assign(
        cl, pb, {"boxes": tb, "classes": tc, "valid": tv}, LEVELS))(
        jnp.asarray(logits), jnp.asarray(pred), *(
            jnp.asarray(tg[k]) for k in ("boxes", "classes", "valid")))
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(ref["pos"]))
    np.testing.assert_array_equal(got["assigned_gt"].numpy(),
                                  np.asarray(ref["assigned_gt"]))
    agt = got["assigned_gt"].numpy()[got["pos"].numpy()]
    assert (agt == 0).any() and not (agt == 1).any()


def test_segmentation_loss_ties_take_lowest_index():
    """More than ``max_pos`` positives of one soft target: the mask loss
    takes the lowest anchor indices, as ``jax.lax.top_k`` does, and
    equals JAX's within 1e-6 relative; taking the highest indices gives
    another loss, so the check can tell."""
    rng = np.random.default_rng(8)
    n = N_ANCHORS
    proto = rng.normal(0, 1, (B, HP, WP, 32)).astype(np.float32)
    coef = rng.normal(0, 1, (B, n, 32)).astype(np.float32)
    tg = targets_of(rng)
    pos = np.zeros((B, n), bool)
    pos[:, ::2] = True                        # 84 positives a frame
    soft = np.where(pos, np.float32(0.5), np.float32(0)).astype(np.float32)
    agt = rng.integers(0, 4, (B, n)).astype(np.int32)
    jassign = {"pos": jnp.asarray(pos), "norm_align": jnp.asarray(soft),
               "assigned_gt": jnp.asarray(agt)}
    ref = float(jtrain.segmentation_loss(
        jnp.asarray(proto), jnp.asarray(coef), jassign,
        jnp.asarray(tg["masks"]), jnp.asarray(tg["boxes"]), LEVELS))
    assign = {"pos": torch.from_numpy(pos),
              "norm_align": torch.from_numpy(soft),
              "assigned_gt": torch.from_numpy(agt).long()}
    got = float(ttrain.segmentation_loss(
        torch.from_numpy(proto), torch.from_numpy(coef), assign,
        torch.from_numpy(tg["masks"]), torch.from_numpy(tg["boxes"]),
        LEVELS))
    assert rel(got, ref) <= 1e-6
    flip = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, ::-1]))
    reversed_assign = {"pos": flip(pos), "norm_align": flip(soft),
                       "assigned_gt": flip(agt).long()}
    other = float(ttrain.segmentation_loss(
        torch.from_numpy(proto), flip(coef), reversed_assign,
        torch.from_numpy(tg["masks"]), torch.from_numpy(tg["boxes"]),
        LEVELS))
    assert rel(other, ref) > 1e-3


def raw_outputs(rng):
    """Seeded raw network outputs of the n network at (64, 128)."""
    out = {"box": [], "cls": [], "coef": []}
    for h, w in LEVELS:
        out["box"].append(rng.normal(0, 2, (B, h, w, 64)))
        out["cls"].append(rng.normal(-3, 2, (B, h, w, 80)))
        out["coef"].append(rng.normal(0, 1, (B, h, w, 32)))
    out = {k: [v.astype(np.float32) for v in vs] for k, vs in out.items()}
    out["proto"] = rng.normal(0, 1, (B, HP, WP, 32)).astype(np.float32)
    return out


@pytest.mark.parametrize("assigner", ["tal", "center"])
def test_detection_loss_matches_jax(assigner):
    """``detection_loss`` with the TAL assigner and the mask loss, and
    with the center assigner, on seeded raw outputs and targets: the
    parts within 1e-5 relative, and the total's gradients with respect to
    every raw output within 1e-5 of that output's largest gradient
    (float32 sums in another order)."""
    rng = np.random.default_rng(7)
    raw = raw_outputs(rng)
    # predicted boxes near the targets, so that TAL has positives
    tg = targets_of(rng)
    loss_fn = functools.partial(jtrain.detection_loss, num_classes=80,
                                level_shapes=LEVELS, assigner=assigner)
    jraw = jax.tree_util.tree_map(jnp.asarray, raw)
    (jtot, jparts), jgrad = jax.jit(jax.value_and_grad(
        lambda o: loss_fn(o, jax_targets(tg)), has_aux=True))(jraw)
    traw = {k: ([torch.from_numpy(v).requires_grad_() for v in vs]
                if isinstance(vs, list)
                else torch.from_numpy(vs).requires_grad_())
            for k, vs in raw.items()}
    ttot, tparts = ttrain.detection_loss(traw, torch_targets(tg), 80,
                                         LEVELS, assigner=assigner)
    want = {"cls", "box", "dfl"} | ({"seg"} if assigner == "tal" else set())
    assert set(tparts) == set(jparts) == want
    assert rel(ttot, jtot) <= 1e-5
    for key in want:
        assert rel(tparts[key], jparts[key]) <= 1e-5, key
        assert float(jparts[key]) > 0, key
    leaves = [*traw["box"], *traw["cls"], *traw["coef"], traw["proto"]]
    grads = torch.autograd.grad(ttot, leaves, allow_unused=True)
    refs = [*jgrad["box"], *jgrad["cls"], *jgrad["coef"], jgrad["proto"]]
    for g, r in zip(grads, refs):
        r = np.asarray(r)
        if g is None:
            assert not r.any()
            continue
        scale = max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * scale)


def test_schedule_and_adamw_match_optax():
    """``warmup_cosine_decay_schedule`` against optax's at counts through
    the warm-up, the cosine and past it: float64 values within 1e-12
    relative of optax's under JAX's 64-bit mode, and within 2e-6 relative
    of optax's 32-bit mode (which rounds its intermediate values to
    float32); then AdamW under the
    schedule against ``optax.adamw(schedule, 5e-4)`` over 6 counts:
    parameters and moments within 1e-7, the counts of Adam and of the
    schedule as optax's, and the state's layout flax's ``to_state_dict``
    of optax's state."""
    args = (1e-4, 2e-3, 3, 8, 2e-5)
    jsched = optax.warmup_cosine_decay_schedule(*args)
    tsched = toptim.warmup_cosine_decay_schedule(*args)
    for count in range(12):
        assert rel(tsched(count), float(jsched(count))) <= 1e-12, count
        with jax.enable_x64(False):
            ref32 = np.float32(jsched(jnp.asarray(count, jnp.int32)))
        assert rel(np.float32(tsched(count)), ref32) <= 2e-6, count
    assert toptim.rate_at(tsched, 0) == np.float32(1e-4)

    rng = np.random.default_rng(1)
    shapes = {"a.weight": (16, 9), "a.bias": (16,), "c.weight": (4, 4, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    tx = optax.adamw(jsched, weight_decay=5e-4)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = toptim.AdamWState.zeros(tparams)
    for _ in range(6):
        grads = {k: rng.normal(0, 0.5, s).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v)
                                 for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = toptim.adamw_update(
            tparams, {k: torch.from_numpy(v) for k, v in grads.items()},
            tstate, toptim.rate_at(tsched, tstate.count), 5e-4)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-7, err_msg=k)
    laid = toptim.adamw_state_dict(tstate, lambda tree: {
        k: v.numpy() for k, v in tree.items()}, schedule=True)
    ref = serialization.to_state_dict(jstate)
    assert laid.keys() == ref.keys() and laid["1"] == ref["1"] == {}
    assert int(laid["0"]["count"]) == int(ref["0"]["count"]) == 6
    assert int(laid["2"]["count"]) == int(ref["2"]["count"]) == 6
    assert laid["0"]["count"].dtype == np.asarray(ref["0"]["count"]).dtype
    for key in ("mu", "nu"):
        for k in shapes:
            np.testing.assert_allclose(laid["0"][key][k],
                                       np.asarray(ref["0"][key][k]), rtol=0,
                                       atol=1e-7)
    back = toptim.adamw_state_from_dict(laid, lambda tree: {
        k: torch.from_numpy(v) for k, v in tree.items()}, "cpu")
    assert back.count == 6 and all(torch.equal(back.mu[k], tstate.mu[k])
                                   for k in shapes)
    const = toptim.adamw_state_dict(tstate, dict, schedule=False)
    assert const["2"] == serialization.to_state_dict(
        optax.adamw(1e-3).init(jparams))["2"] == {}


def test_ema_recurrence_matches_jax_expression():
    """The trainer's EMA over 5 steps against the JAX step's expression
    (``parallel/train.py:462-469``: ``d = min(decay, (1 + t) / (10 + t))``,
    ``e * d + v * (1 - d)`` in float32), bit for bit."""
    tr = ttrain.YoloTrainer(YoloConfig(scale="n"), image_size=(H, W),
                            max_targets=T, ema_decay=0.6, device="cpu")
    rng = np.random.default_rng(2)
    keys = list(tr.state.ema)[:6]
    ema = {k: tr.state.ema[k].numpy().copy() for k in keys}
    sd = tr.model.state_dict()
    for step in range(1, 6):
        for k in keys:
            sd[k].copy_(torch.from_numpy(
                rng.normal(0, 1, tuple(sd[k].shape)).astype(np.float32)))
        tr.state.step = step
        tr.update_ema()
        with jax.enable_x64(False):
            t = jnp.asarray(step, jnp.int32)
            d = jnp.minimum(0.6, (1.0 + t) / (10.0 + t))
            ema = {k: np.asarray(jnp.asarray(ema[k]) * d
                                 + jnp.asarray(sd[k].numpy()) * (1.0 - d))
                   for k in keys}
        for k in keys:
            np.testing.assert_array_equal(tr.state.ema[k].numpy(), ema[k])


# ---------------------------------------------------------------------------
# one whole step from the committed n variables
# ---------------------------------------------------------------------------

def _capture_grads():
    """An optax transformation that passes the gradients through and
    keeps them as its state, so that JAX's ``_train_step`` returns them."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


SCHEDULE = (1e-3, 2e-3, 2, 10, 2e-5)


@pytest.fixture(scope="module")
def step_case():
    """One step of the JAX package's ``_train_step`` (jitted, 32-bit
    mode, as the trainer runs) and of the port's trainer, from the
    committed n variables, on crops of the committed frame, with the
    warm-up schedule (a nonzero first rate) and the EMA on."""
    variables = read_flax_msgpack(CKPT)["variables"]
    images = crops()
    tg = targets_of(np.random.default_rng(11))
    jtx = optax.chain(_capture_grads(),
                      optax.adamw(optax.warmup_cosine_decay_schedule(
                          *SCHEDULE), weight_decay=5e-4))
    step = jax.jit(functools.partial(
        jtrain._train_step, model=JYolo11(JYoloConfig(scale="n")), tx=jtx,
        num_classes=80, level_shapes=LEVELS, seg_weight=1.0, ema_decay=0.9))
    with jax.enable_x64(False):
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)
        state = jtrain.TrainState(
            variables=jvars, opt_state=jtx.init(jvars["params"]),
            step=jnp.zeros((), jnp.int32), ema_variables=jvars)
        jstate, jm = step(state, jnp.asarray(images), jax_targets(tg))
        jstate = jax.tree_util.tree_map(np.asarray, jstate)
        jm = {k: np.asarray(v) for k, v in jm.items()}

    tr = ttrain.YoloTrainer(
        YoloConfig(scale="n"), image_size=(H, W), max_targets=T,
        ema_decay=0.9,
        learning_rate=toptim.warmup_cosine_decay_schedule(*SCHEDULE),
        device="cpu")
    tr.load(variables)
    timgs, ttg = tr.put(images, tg)
    loss, parts = tr.loss(timgs, ttg)
    grads = tr.gradients(loss)
    tr.update(grads)
    return {"jstate": jstate, "jm": jm, "trainer": tr, "loss": loss,
            "parts": parts, "grads": grads}


def test_train_step_loss_and_gradients_match_jax(step_case):
    """One whole step from the committed n variables on a (2, 64, 128)
    batch: the loss and its parts (cls, box, dfl, seg) within 1e-4
    relative; every parameter's gradient within STEP_TOL of its tensor's
    largest entry, but the three that are 0 but for rounding, which stay
    within YOLO_ZERO_GRAD_SHARE of the largest gradient on both sides."""
    jm, parts = step_case["jm"], step_case["parts"]
    assert rel(step_case["loss"], jm["loss"]) <= 1e-4
    for key in ("cls", "box", "dfl", "seg"):
        assert rel(parts[key], jm[key]) <= 1e-4, key
    assert int(jm["step"]) == step_case["trainer"].state.step == 1
    tgrads = yolo_flax_from_state(step_case["grads"])["params"]
    jgrads = step_case["jstate"].opt_state[0]
    worst = assert_close_scaled(tgrads, jgrads, STEP_TOL, "gradients")
    zero = [chip_smoke.zero_grad_share(g) for g in (tgrads, jgrads)]
    print(f"gradients within {worst:.3g} of each tensor's largest; the "
          f"leaves that are 0 but for rounding at {zero} of the largest")
    assert max(zero) <= chip_smoke.YOLO_ZERO_GRAD_SHARE


def check_update(got, ref, start, grads, ref_grads, step, what):
    """Adam's first update against JAX's, element by element.  It is
    ``-step * (u + wd * p)`` with ``u = g / (|g| + eps)``, the gradient's
    sign but within eps of 0, so the two updates differ by what their
    gradients' ``u`` (``grads``, ``ref_grads``) differ by, times the
    step; that is held within 1e-3 of the step plus two ulps of the
    value.  Returns the count of elements whose ``u`` differ by more than
    1e-3 (gradients of either sign, or within rounding of eps)."""
    got, ref, start = flat(got), flat(ref), flat(start)
    grads, ref_grads = flat(grads), flat(ref_grads)
    assert got.keys() == ref.keys() == grads.keys(), what
    u = lambda g: g.astype(np.float64) / (np.abs(g.astype(np.float64))
                                          + 1e-8)
    moved = 0
    for key, r in ref.items():
        du = u(grads[key]) - u(ref_grads[key])
        moved += int((np.abs(du) > 1e-3).sum())
        err = ((got[key] - start[key]).astype(np.float64)
               - (r - start[key]) + step * du)
        slack = 2 * np.spacing(np.abs(start[key]) + step)
        assert (np.abs(err) <= 1e-3 * step + slack).all(), (what, key)
    return moved


def test_train_step_state_matches_jax(step_case):
    """After the step: updated BatchNorm statistics and AdamW's moments
    each within STEP_TOL of its tensor's largest entry (the second moment
    within 2 STEP_TOL: it squares the gradient); the parameters' update
    and the EMA's (d = 2/11 after one step) as ``check_update`` holds
    them, at a first rate of 1e-3; Adam's and the schedule's counts 1."""
    tr, jstate = step_case["trainer"], step_case["jstate"]
    got = tr.variables()
    assert_close_scaled(got["batch_stats"],
                        jstate.variables["batch_stats"], STEP_TOL, "stats")
    assert_close_scaled(tr.ema_variables()["batch_stats"],
                        jstate.ema_variables["batch_stats"], STEP_TOL,
                        "ema stats")
    init = read_flax_msgpack(CKPT)["variables"]["params"]
    grads = (yolo_flax_from_state(step_case["grads"])["params"],
             jstate.opt_state[0])
    free = check_update(got["params"], jstate.variables["params"], init,
                        *grads, SCHEDULE[0], "parameters")
    check_update(tr.ema_variables()["params"],
                 jstate.ema_variables["params"], init, *grads,
                 SCHEDULE[0] * (1 - 2 / 11), "ema")
    n = sum(v.size for v in flat(init).values())
    print(f"{free} of {n} parameters whose first Adam step differs by "
          f"more than 1e-3 of the rate (gradients of either sign)")
    assert free < 1e-3 * n
    opt = tr.opt_state_dict()
    adam = jstate.opt_state[1][0]
    assert int(opt["0"]["count"]) == int(adam.count) == 1
    assert int(opt["2"]["count"]) == int(jstate.opt_state[1][2].count) == 1
    assert_close_scaled(opt["0"]["mu"], adam.mu, STEP_TOL, "mu")
    assert_close_scaled(opt["0"]["nu"], adam.nu, 2 * STEP_TOL, "nu")


# ---------------------------------------------------------------------------
# the initializer and the weights' round trip
# ---------------------------------------------------------------------------

def test_initializer_matches_flax_defaults():
    """The port's initializer of the n network: the tree's paths, shapes
    and dtypes are the committed checkpoint's (a Flax init's); every
    kernel's standard deviation within 10 % of ``lecun_normal``'s
    sqrt(1 / fan_in) (432 to 147,456 draws a tensor), its mean near 0 and
    no value past two of its standard deviations; biases 0, BatchNorm
    scales 1, statistics 0 and 1; the same seed gives the same bits,
    another seed other bits, and the caller's generator is untouched."""
    torch.manual_seed(123)
    probe = torch.rand(3)
    torch.manual_seed(123)
    model = tinit.initialize(Yolo11(YoloConfig(scale="n")), seed=0)
    got = flat(yolo_flax_from_state(model.state_dict()))
    ref = flat(read_flax_msgpack(CKPT)["variables"])
    assert got.keys() == ref.keys()
    n_kernels = 0
    for key, value in got.items():
        assert value.shape == ref[key].shape and value.dtype == np.float32
        if key.endswith("['kernel']"):
            n_kernels += 1
            # Flax's fan-in of any kernel: every axis but the last (the
            # Proto's (in, out, 2, 2) transposed kernel included)
            fan_in = int(np.prod(value.shape[:-1]))
            std = np.sqrt(1.0 / fan_in)
            assert abs(value.std() / std - 1) < 0.10, key
            assert abs(value.mean()) < 0.1 * std, key
            assert np.abs(value).max() <= 2 * std / tinit_truncated() * (
                1 + 1e-6), key
        elif key.endswith("['scale']") or key.endswith("['var']"):
            assert (value == 1).all(), key
        else:
            assert (value == 0).all(), key
    assert n_kernels >= 100
    again = tinit.initialize(Yolo11(YoloConfig(scale="n")), seed=0)
    other = tinit.initialize(Yolo11(YoloConfig(scale="n")), seed=1)
    for (k, a), b, c in zip(model.state_dict().items(),
                            again.state_dict().values(),
                            other.state_dict().values()):
        assert torch.equal(a, b), k
        if a.dim() >= 2:
            assert not torch.equal(a, c), k
    trainer = ttrain.YoloTrainer(YoloConfig(scale="n"), device="cpu")
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    assert trainer.model.training is True
    torch.manual_seed(123)
    assert torch.equal(torch.rand(3), probe)


def test_serving_detector_is_in_eval_mode():
    """``nn.Module`` starts in training mode, where the port's BatchNorm
    takes the batch's statistics: the serving constructor leaves every
    module in eval mode, and two detections give the same outputs and
    leave the running statistics as loaded."""
    variables = read_flax_msgpack(CKPT)["variables"]
    det = tdist.YoloDetector((96, 320), YoloConfig(scale="n"),
                             variables=variables, device="cpu")
    assert not any(m.training for m in det.model.modules())
    images = (crops() * 255).astype(np.uint8)[:, :, :, :]
    before = {k: v.clone() for k, v in det.model.state_dict().items()}
    first, again = det.detect(images), det.detect(images)
    for key in first:
        assert torch.equal(first[key], again[key]), key
    for key, value in det.model.state_dict().items():
        assert torch.equal(value, before[key]), key


def tinit_truncated():
    from lidar_object_detection_tpu_torch.models.common import (
        TRUNCATED_STD)
    return TRUNCATED_STD


def test_weights_round_trip_bit_exact():
    """``yolo_flax_from_state`` inverts ``from_flax_variables`` bit for
    bit, both ways, ``batch_stats`` and the transposed kernel included,
    the dtypes kept."""
    variables = read_flax_msgpack(CKPT)["variables"]
    back = yolo_flax_from_state(from_flax_variables(variables))
    a, b = flat(variables), flat(back)
    assert a.keys() == b.keys()
    assert any("batch_stats" in k for k in a)
    for key, value in a.items():
        assert b[key].dtype == value.dtype, key
        np.testing.assert_array_equal(b[key], value, err_msg=key)
    sd = tinit.initialize(Yolo11(YoloConfig(scale="n")), seed=5).state_dict()
    again = from_flax_variables(yolo_flax_from_state(sd))
    assert sd.keys() == again.keys()
    for key, value in sd.items():
        assert torch.equal(again[key], value), key


def test_training_step_launches_no_kernel():
    """A training step launches none of the port's CUDA kernels (the JAX
    step reaches no Pallas kernel); on the CPU the counters stay 0."""
    tr = ttrain.YoloTrainer(YoloConfig(scale="n"), image_size=(H, W),
                            max_targets=T, device="cpu")
    kernel_lib.reset_launches()
    m = tr.train_step(crops(), targets_of(np.random.default_rng(3)))
    assert np.isfinite(float(m["loss"])) and m["step"] == 1
    assert not any(kernel_lib.LAUNCHES.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.YoloTrainer(YoloConfig(scale="n"))


def test_trainer_refuses_a_batch_of_other_shapes():
    """A batch has the trainer's image size and target slots, as the JAX
    trainer's compiled step takes them: ``put`` refuses others."""
    tr = ttrain.YoloTrainer(YoloConfig(scale="n"), image_size=(H, W),
                            max_targets=T, device="cpu")
    images, targets = crops(), targets_of(np.random.default_rng(5))
    tr.put(images, targets)
    with pytest.raises(ValueError, match="targets a frame"):
        tr.put(images, targets_of(np.random.default_rng(5), t=T + 1))
    with pytest.raises(ValueError, match="targets a frame"):
        tr.put(images[:, :, : W // 2], targets)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "train_yolo_distill_example",
        os.path.join(REPO, "examples", "train_yolo_distill.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def example():
    return _jax_example()


@pytest.fixture(scope="module")
def distill_tree(tmp_path_factory):
    """A KITTI-360 tree of the two committed camera frames, each scan
    built around the committed n checkpoint's detections of its frame
    (``chip_smoke.make_scene``: a box and 1024 points per detection at
    8-20 m, more boxes scattered, background points), 40,000 points and
    24 box slots a frame."""
    images = np.stack([read_png_rgb(p) for p in chip_smoke.FRAMES])
    det = tdist.YoloDetector((tdist.IMG_H, tdist.IMG_W),
                             YoloConfig(scale="n"),
                             variables=read_flax_msgpack(CKPT)["variables"],
                             max_detections=tdist.MAX_T, device="cpu")
    first = det.detect(images)
    rng = np.random.default_rng(9)
    frames = []
    for b, path in enumerate(chip_smoke.FRAMES):
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, first["boxes"][b].numpy(), first["det_valid"][b].numpy(),
            num_points=40000, num_boxes=24, num_valid=16)
        frames.append((100 + b, path, points[pvalid], corners[bvalid]))
    root = str(tmp_path_factory.mktemp("distill") / "kitti360")
    chip_smoke.write_kitti360_tree(root, frames)
    return root


@pytest.fixture(scope="module")
def labels(distill_tree):
    return tdist.build_labels(distill_tree, device="cpu")


def test_build_labels_match_jax_bit_for_bit(example, distill_tree, labels,
                                            tmp_path):
    """``build_labels`` on the synthetic tree gives the JAX runner's
    arrays bit for bit (images, boxes in image and letterbox pixels,
    classes, validity, full-resolution and prototype masks, frame ids,
    recipe), and the cache round-trips: a second call reads it."""
    ref = example.build_labels(distill_tree)
    assert sorted(labels) == sorted(ref)
    for key, value in ref.items():
        assert labels[key].dtype == value.dtype, key
        np.testing.assert_array_equal(labels[key], value, err_msg=key)
    assert labels["valid"].sum() >= 4
    assert labels["masks_pr"].shape == (2, tdist.MAX_T, 48, 160)
    cache = str(tmp_path / "labels.npz")
    tdist.build_labels(distill_tree, cache=cache, device="cpu")
    again = tdist.build_labels("no tree needed", cache=cache, device="cpu")
    for key, value in labels.items():
        np.testing.assert_array_equal(again[key], value, err_msg=key)


def test_build_labels_runs_on_the_card_by_default(distill_tree):
    """``build_labels`` runs its point-in-box tests on the card unless the
    caller passes ``device="cpu"``; where no card is present it raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdist.build_labels(distill_tree)


def _trained_state(ema=True):
    """A port trainer one step past the committed n variables, the
    schedule and (optionally) the EMA on."""
    tr = ttrain.YoloTrainer(
        YoloConfig(scale="n"), image_size=(H, W), max_targets=T,
        learning_rate=toptim.warmup_cosine_decay_schedule(*SCHEDULE),
        ema_decay=0.9 if ema else 0.0, device="cpu")
    tr.load(read_flax_msgpack(CKPT)["variables"])
    tr.train_step(crops(), targets_of(np.random.default_rng(4)))
    return tr


def test_checkpoint_bytes_match_jax_and_jax_reads_them(example, tmp_path):
    """``save_ckpt`` writes the JAX runner's bytes for the same state (the
    msgpack of variables, step and EMA, the ``.opt`` file of optax's
    state, the ``.json`` metadata), and the JAX runner's
    ``load_ckpt_variables`` and flax's ``from_state_dict`` into
    ``optax.adamw``'s state read the port's files."""
    tr = _trained_state()
    variables, ema = tr.variables(), tr.ema_variables()
    opt = tr.opt_state_dict()
    ours = str(tmp_path / "port.msgpack")
    tdist.save_ckpt(ours, variables, opt, 7, ema_variables=ema)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(*SCHEDULE),
                     weight_decay=5e-4)
    template = tx.init(jax.tree_util.tree_map(jnp.asarray,
                                              variables["params"]))
    jopt = serialization.from_state_dict(template, opt)
    theirs = str(tmp_path / "jax.msgpack")
    example.save_ckpt(theirs, variables, jopt, 7, ema_variables=ema)
    for suffix in ("", ".opt", ".json"):
        with open(ours + suffix, "rb") as a, open(theirs + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    got, step = example.load_ckpt_variables(ours, prefer_ema=True)
    assert step == 7
    for key, value in flat(ema).items():
        np.testing.assert_array_equal(flat(got)[key], value)
    with open(ours + ".opt", "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    restored = serialization.from_state_dict(template, raw["opt_state"])
    assert int(restored[0].count) == int(restored[2].count) == 1
    for key, value in flat(opt["0"]["nu"]).items():
        np.testing.assert_array_equal(flat(restored[0].nu)[key], value)
    plain = _trained_state(ema=False)
    tdist.save_ckpt(ours, plain.variables(), plain.opt_state_dict(), 1)
    assert "ema_variables" not in read_flax_msgpack(ours)
    assert tdist.load_ckpt_variables(ours, prefer_ema=True)[1] == 1


def _file_bytes(path):
    return {s: open(path + s, "rb").read() for s in ("", ".opt", ".json")}


def test_resume_equals_straight_run_bit_for_bit(labels, tmp_path, capsys):
    """``train`` for 2 steps, then resumed to 4, writes the bytes of 4
    straight steps (variables, EMA, step, optimizer state with the
    schedule's count), on the CPU at the runner's 192 x 640 on every
    labelled frame; the loss log goes down the same way."""
    straight = str(tmp_path / "straight.msgpack")
    tdist.train(labels, 4, 2e-3, straight, ema_decay=0.9, seed=3,
                log_every=1, device="cpu")
    log_straight = capsys.readouterr().out
    resumed = str(tmp_path / "resumed.msgpack")
    tdist.train(labels, 2, 2e-3, resumed, ema_decay=0.9, seed=3,
                log_every=1, device="cpu")
    tdist.train(labels, 4, 2e-3, resumed, ema_decay=0.9, seed=3,
                resume=True, log_every=1, device="cpu")
    log_resumed = capsys.readouterr().out
    assert "resumed from" in log_resumed and "at step 2" in log_resumed
    assert _file_bytes(straight) == _file_bytes(resumed)
    opt = read_flax_msgpack(straight + ".opt")["opt_state"]
    assert int(opt["0"]["count"]) == int(opt["2"]["count"]) == 4
    losses = [line.split(" loss ")[1].split()[0]
              for line in log_straight.splitlines() if " loss " in line]
    assert len(losses) == 4 and all(np.isfinite(float(x)) for x in losses)
    meta = json.load(open(straight + ".json"))
    assert meta == {"model": "yolo11-seg", "scale": "n", "num_classes": 80,
                    "image_size": [192, 640], "step": 4}


def test_evaluate_line_matches_jax(example, labels, tmp_path, capsys,
                                   monkeypatch):
    """``evaluate`` on a checkpoint of the committed n variables (saved
    by the port at step 12000) prints the JAX runner's JSON line: TP, FP,
    FN, recall, precision and mean mask IoU, with TP > 0."""
    from lidar_object_detection_tpu.utils import cache
    monkeypatch.setattr(cache, "enable_compilation_cache", lambda: None)
    ckpt = str(tmp_path / "n.msgpack")
    tr = _trained_state(ema=False)
    tdist.save_ckpt(ckpt, read_flax_msgpack(CKPT)["variables"],
                    tr.opt_state_dict(), 12000)
    got = tdist.evaluate(labels, ckpt, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    ref = example.evaluate(labels, ckpt)
    ref_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == ref_line
    assert got == tuple(ref) and got[0] > 0, line


def test_cli_runs_labels_train_checkpoint_evaluation(distill_tree, tmp_path,
                                                     capsys, monkeypatch):
    """``python -m ...pipelines.yolo_distill`` on the CPU: labels (cached),
    2 steps with the EMA, the checkpoint and its sidecars, then the
    evaluation's JSON line through ``YoloDetector``; ``--eval-only``
    prints the same line; ``--make-labels`` writes only the cache; no
    dataset refuses."""
    ckpt = str(tmp_path / "cli.msgpack")
    cache = str(tmp_path / "labels.npz")
    base = ["--dataset", distill_tree, "--ckpt", ckpt, "--cache", cache,
            "--device", "cpu"]
    assert tdist.main(base + ["--make-labels"]) == 0
    assert os.path.exists(cache) and not os.path.exists(ckpt)
    capsys.readouterr()
    kernel_lib.reset_launches()
    assert tdist.main(base + ["--steps", "2", "--ema-decay", "0.9"]) == 0
    out = capsys.readouterr().out
    assert "[labels] cached <-" in out and "[train] ckpt ->" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["ckpt_step"] == 2
    raw = read_flax_msgpack(ckpt)
    assert set(raw) == {"variables", "step", "ema_variables"}
    assert tdist.main(base + ["--eval-only"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again == line
    assert not any(kernel_lib.LAUNCHES.values())
    monkeypatch.delenv("LIDAR_TPU_KITTI360", raising=False)
    with pytest.raises(SystemExit):
        tdist.main(["--ckpt", ckpt, "--device", "cpu"])


def test_card_test_file_imports_nothing_of_jax():
    """``test_torch_cuda_yolo_train.py`` collects on the card's machine,
    where JAX and Flax are missing: it imports ``chip_smoke`` and no
    forbidden module."""
    from test_torch_hygiene import _forbidden, _imported_names

    names = _imported_names(os.path.join(REPO, "tests",
                                         "test_torch_cuda_yolo_train.py"))
    assert "chip_smoke" in names
    assert _forbidden(names) == []
