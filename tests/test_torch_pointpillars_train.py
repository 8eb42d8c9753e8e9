"""The port's PointPillars training modules against the JAX package's, on
the same seeded numpy inputs at the TINY size of
``test_torch_pointpillars.py`` (a 64 x 64 pillar grid, 2048 anchors), two
frames of a few thousand points and 8 GT slots.

Tolerances, stated per check (each test's docstring says why):
- rotated IoUs of pairs within 1e-6 (coordinates within 6 m); the
  assigner's dense matrix over the 20 m grid within IOU_TOL = 5e-5 of
  the jitted JAX function (XLA fuses the clip and contracts its
  multiply-adds, and the shoelace sums products of absolute coordinates,
  up to 215 m^2 here, whose float32 ulp is 1.5e-5);
  assignments (matched, pos, neg): exact, no deciding IoU being within
  IOU_TOL of a threshold;
- loss parts: 1e-5 relative; gradients with respect to the raw heads:
  1e-5 of each head's largest gradient;
- center targets, radii, point counts and starvation weights: exact or
  1e-6;
- train-mode BatchNorm outputs and running statistics: 1e-5;
- AdamW against ``optax.adamw`` over 5 steps: 1e-7;
- one full training step per head from JAX's initial variables: loss
  parts 1e-4 relative, per-tensor gradients 1e-4 of the tensor's largest,
  running statistics 1e-5, the losses of steps 2-3 1e-4 relative;
- the center head's curve over 4 steps of 4 batches: num_pos exact, each
  loss 1e-4 relative;
- augmentation and the weight round trip: bit for bit;
- the port's initializer: per-tensor standard deviation within 10 % of
  Flax's at full width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_object_detection_tpu.models import pointpillars as jpp
from lidar_object_detection_tpu.models.pointpillars import augment as jaug
from lidar_object_detection_tpu.models.pointpillars import center as jcenter
from lidar_object_detection_tpu.models.pointpillars import loss as jloss
from lidar_object_detection_tpu.models.pointpillars import model as jmodel
from lidar_object_detection_tpu.ops import rotated_iou as jiou
from lidar_object_detection_tpu_torch.models import pointpillars as tpp
from lidar_object_detection_tpu_torch.models.common import TRUNCATED_STD
from lidar_object_detection_tpu_torch.models.pointpillars import (
    augment as taug)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    center as tcenter)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    init as tinit)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    loss as tloss)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    model as tmodel)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    train as ttrain)
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.ops.rotated_iou import (
    rotated_iou_pairs)

TINY_GRID = dict(x_range=(0.0, 20.48), y_range=(-10.24, 10.24),
                 pillar_size=0.32)
TINY = dict(embed_dim=16, backbone_channels=(16, 32, 64),
            backbone_layers=(1, 1, 1), up_channels=16)
B, G, P = 2, 8, 3000
HEAD_HW = (32, 32)      # the TINY grid's head resolution
IOU_TOL = 5e-5


def configs(head="ssd", grid=TINY_GRID, **kw):
    """The same PillarsConfig in both packages."""
    kw = {**TINY, **kw}
    return (jpp.PillarsConfig(grid=jpp.PillarGridConfig(**grid), head=head,
                              **kw),
            tpp.PillarsConfig(grid=tpp.PillarGridConfig(**grid), head=head,
                              **kw))


def anchors_of(tcfg):
    return tpp.anchor_grid(tcfg).reshape(-1, 7)


def gt_boxes(rng, anchors):
    """(B, G, 7) float32 GT boxes and (B, G) validity over the TINY grid:
    per frame two copies of anchors (IoU 1), two anchors shifted by a
    fraction of a cell (IoUs between the thresholds), two car boxes of any
    yaw, and two invalid slots of zeros.  The anchors come from distinct
    cells: two GTs on one center tie exactly for the anchors around them,
    and float32 rounding then decides their ``matched``."""
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


def car_cloud(rng, gt, valid, per_box=300, clutter=1200):
    """(B, P, 4) float32 points on the GT boxes and over the grid, all
    valid."""
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
        xyz = np.concatenate(chunks)[:P]
        pts[b, :, :3] = xyz
        pts[b, :, 3] = rng.uniform(0, 1, P)
    return pts, np.ones((B, P), bool)


def _rel(got, ref):
    got = float(got.detach()) if torch.is_tensor(got) else float(got)
    ref = float(np.asarray(ref))
    return abs(got - ref) / max(abs(ref), 1e-12)


# ---------------------------------------------------------------------------
# the rotated IoU of pairs and the assigner
# ---------------------------------------------------------------------------

def test_rotated_iou_pairs_twin_matches_jax(rng):
    """The twin of the assigner's kernel against JAX's
    ``rotated_iou_matrix`` entry by entry, within 1e-6 (float32 clips in
    the same order; the bound covers a rounding of the shoelace sum): car
    boxes of any yaw in heavy overlap, identical and nested boxes, boxes
    thinner than a millimetre, zero-size boxes, and disjoint ones."""
    n = 96
    a = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(-1, 1, n), rng.uniform(1.5, 2.0, n),
                  rng.uniform(3.5, 4.8, n), rng.uniform(1.4, 1.7, n),
                  rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    b = a[rng.permutation(n)].copy()
    b[:8] = a[:8]                                   # identical
    b[8:16] = a[8:16]
    b[8:16, 3:5] *= np.float32(0.5)                 # nested
    b[16:24, 3] = np.float32(1e-4)                  # slivers
    a[24:28, 3:5] = 0                               # zero-size
    b[28:36, :2] += np.float32(40.0)                # disjoint
    b[36:44, 6] = a[36:44, 6] + np.float32(np.pi / 2)
    got = rotated_iou_pairs(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.diagonal(np.asarray(jax.jit(jiou.rotated_iou_matrix)(
        jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:8], 1.0, rtol=0, atol=1e-6)
    assert (got.numpy()[28:36] == 0).all()
    assert 0.2 < float(got[8:16].min()) and float(got[8:16].max()) < 0.3
    # the batched form: any leading shape
    got2 = rotated_iou_pairs(torch.from_numpy(a).reshape(4, 24, 7),
                             torch.from_numpy(b).reshape(4, 24, 7))
    assert torch.equal(got2.reshape(-1), got)


@pytest.fixture(scope="module")
def assign_case():
    rng = np.random.default_rng(11)
    jcfg, tcfg = configs()
    anchors = anchors_of(tcfg).numpy()
    gt, valid = gt_boxes(rng, anchors)
    return jcfg, tcfg, anchors, gt, valid


def test_rotated_iou_topk_matches_jax(assign_case):
    """The sparse exact IoU matrix (AABB bound, top 512 per GT, the exact
    clip, the scatter back), dense (B, N, G), within IOU_TOL of JAX's in
    the valid GTs' columns, and 0 in the invalid ones (zero-size boxes, whose
    clip keeps the whole anchor: their IoU is a rounding of area - area,
    masked by the assignment in both packages); the candidates' IoUs from
    the twin, no kernel launched on the CPU."""
    jcfg, tcfg, anchors, gt, valid = assign_case
    before = dict(kernel_lib.LAUNCHES)
    got = tloss._rotated_iou_topk(torch.from_numpy(anchors),
                                  torch.from_numpy(gt),
                                  torch.from_numpy(valid)).numpy()
    assert kernel_lib.LAUNCHES == before
    fn = jax.jit(jax.vmap(lambda g: jloss._rotated_iou_topk(
        jnp.asarray(anchors), g)))
    ref = np.asarray(fn(jnp.asarray(gt)))
    assert got.shape == ref.shape == (B, len(anchors), G)
    for b in range(B):
        np.testing.assert_allclose(got[b][:, valid[b]], ref[b][:, valid[b]],
                                   rtol=0, atol=IOU_TOL)
        assert (got[b][:, ~valid[b]] == 0).all()
    assert (ref > 0.6).sum() >= 4 * B


@pytest.mark.parametrize("assign_iou", ["rotated", "aabb"])
def test_assign_anchors_matches_jax(assign_case, assign_iou):
    """matched, pos and neg exactly equal to JAX's (vmapped over the
    frames), for both assignment IoUs.  Exact because no deciding IoU lies
    within IOU_TOL of 0.6 or 0.45 (asserted: such a pair could flip on a
    rounding of the IoU)."""
    _, _, anchors, gt, valid = assign_case
    jcfg, tcfg = configs(assign_iou=assign_iou)
    got = tloss.assign_anchors(torch.from_numpy(gt), torch.from_numpy(valid),
                               tcfg, torch.from_numpy(anchors))
    ref = jax.jit(jax.vmap(lambda g, v: jloss.assign_anchors(g, v, jcfg)))(
        jnp.asarray(gt), jnp.asarray(valid))
    for key in ("matched", "pos", "neg"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
    pos = got["pos"].numpy()
    assert pos.sum() >= 4 * B and got["neg"].numpy().sum() > 1000
    if assign_iou == "rotated":
        iou = tloss._rotated_iou_topk(torch.from_numpy(anchors),
                                      torch.from_numpy(gt),
                                      torch.from_numpy(valid)).numpy()
    else:
        iou = tloss.iou_2d_matrix(tpp.bev_aabb(torch.from_numpy(anchors)),
                                  tpp.bev_aabb(torch.from_numpy(gt))).numpy()
    iou = np.where(valid[:, None, :], iou, 0.0)
    close = sum(int((np.abs(iou - t) <= IOU_TOL).sum())
                for t in (0.6, 0.45))
    assert close == 0
    # nor does a positive anchor's GT (the one its targets come from) win
    # by IOU_TOL or less
    top2 = np.sort(iou, axis=2)[..., -2:]
    assert not (pos & (top2[..., 1] - top2[..., 0] <= IOU_TOL)).any()
    # some anchor of every valid GT is positive (the force-match)
    matched = got["matched"].numpy()
    for b in range(B):
        assert set(np.unique(matched[b][pos[b]])) == set(
            np.nonzero(valid[b])[0])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _ssd_heads(rng):
    h, w = HEAD_HW
    return {"cls": rng.normal(-2, 1.5, (B, h, w, 2, 1)),
            "box": rng.normal(0, 0.3, (B, h, w, 2, 7)),
            "dir": rng.normal(0, 1, (B, h, w, 2, 2))}


def _center_heads(rng):
    h, w = HEAD_HW
    return {"heat": rng.normal(-2, 1.5, (B, h, w, 1)),
            "reg": rng.normal(0, 0.5, (B, h, w, 8))}


def _loss_both(jcfg, tcfg, heads, gt, valid, pos_weight):
    """Loss parts and the gradient of the total with respect to the raw
    heads, in both packages."""
    heads = {k: v.astype(np.float32) for k, v in heads.items()}
    cls = np.zeros((B, G), np.int32)
    jpw = None if pos_weight is None else jnp.asarray(pos_weight)

    def jfn(out):
        parts = jloss.pointpillars_loss(out, jnp.asarray(gt),
                                        jnp.asarray(cls), jnp.asarray(valid),
                                        jcfg, gt_pos_weight=jpw)
        return parts["loss"], parts

    (_, jparts), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        {k: jnp.asarray(v) for k, v in heads.items()})
    touts = {k: torch.from_numpy(v).requires_grad_() for k, v in
             heads.items()}
    tparts = tloss.pointpillars_loss(
        touts, torch.from_numpy(gt), torch.from_numpy(cls),
        torch.from_numpy(valid), tcfg,
        gt_pos_weight=None if pos_weight is None
        else torch.from_numpy(pos_weight))
    tparts["loss"].backward()
    return (jparts, jgrad), (tparts, {k: v.grad for k, v in touts.items()})


@pytest.mark.parametrize("head,weighted", [("ssd", False), ("center", False),
                                           ("center", True)])
def test_losses_and_head_gradients_match_jax(assign_case, head, weighted):
    """``pointpillars_loss`` (SSD, rotated assignment) and ``center_loss``
    (with and without per-GT positive weights) on random raw heads: each
    part within 1e-5 relative (float32 sums over 4096 anchors or cells in
    another order), ``num_pos`` exact, and the gradient of the total with
    respect to each head within 1e-5 of that head's largest gradient."""
    _, _, _, gt, valid = assign_case
    jcfg, tcfg = configs(head)
    rng = np.random.default_rng(5)
    heads = _ssd_heads(rng) if head == "ssd" else _center_heads(rng)
    pw = (rng.uniform(1, 3, (B, G)).astype(np.float32) if weighted
          else None)
    (jparts, jgrad), (tparts, tgrad) = _loss_both(jcfg, tcfg, heads, gt,
                                                  valid, pw)
    assert float(tparts["num_pos"]) == float(jparts["num_pos"]) >= 4
    for key in ("loss", "cls", "box", "dir"):
        assert _rel(tparts[key], jparts[key]) <= 1e-5 or \
            abs(float(jparts[key])) == float(tparts[key]) == 0, key
    for key, ref in jgrad.items():
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0
        np.testing.assert_allclose(tgrad[key].numpy(), ref, rtol=0,
                                   atol=1e-5 * scale, err_msg=key)


def test_center_targets_match_jax(assign_case):
    """``render_center_targets`` (heatmaps, center cells, regression
    targets, masks), ``gaussian_radius``, ``gt_point_counts`` and
    ``starve_weights``: cells, masks and counts exact, heatmaps, radii and
    weights within 1e-6 (the same float32 operations); the regression
    targets within 4e-6, the float32 ulp of a center's cell coordinate
    (up to 32 cells: XLA may divide by the cell size as a multiply)."""
    _, _, _, gt, valid = assign_case
    jcfg, tcfg = configs("center", starve_weight=2.0)
    gt = gt.copy()
    gt[0, 5, :2] = [30.0, 0.0]                      # center off the grid
    cls = np.zeros((B, G), np.int32)
    got = tcenter.render_center_targets(torch.from_numpy(gt),
                                        torch.from_numpy(cls),
                                        torch.from_numpy(valid), tcfg)
    ref = jax.jit(jax.vmap(lambda g, c, v: jcenter.render_center_targets(
        g, c, v, jcfg)))(jnp.asarray(gt), jnp.asarray(cls),
                         jnp.asarray(valid))
    for key in ("ind", "mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    for key, tol in (("heat", 1e-6), ("reg", 4e-6)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=tol, err_msg=key)
    assert int(got["mask"].sum()) == int(valid.sum()) - 1
    assert (got["heat"].numpy() == 1.0).sum() == int(got["mask"].sum())
    lw = np.abs(gt[..., 3:5]).astype(np.float32) / np.float32(0.64)
    np.testing.assert_allclose(
        tcenter.gaussian_radius(torch.from_numpy(lw[..., 1]),
                                torch.from_numpy(lw[..., 0])).numpy(),
        np.asarray(jcenter.gaussian_radius(jnp.asarray(lw[..., 1]),
                                           jnp.asarray(lw[..., 0]))),
        rtol=0, atol=1e-6)
    pts, pv = car_cloud(np.random.default_rng(3), gt, valid)
    pv[1, ::7] = False
    counts = tcenter.gt_point_counts(
        torch.from_numpy(pts), torch.from_numpy(pv), torch.from_numpy(gt),
        torch.from_numpy(valid))
    rcounts = jcenter.gt_point_counts(jnp.asarray(pts), jnp.asarray(pv),
                                      jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    assert counts.numpy()[valid].min() > 100
    sw = tcenter.starve_weights(torch.from_numpy(pts), torch.from_numpy(pv),
                                torch.from_numpy(gt), torch.from_numpy(valid),
                                tcfg)
    rsw = jcenter.starve_weights(jnp.asarray(pts), jnp.asarray(pv),
                                 jnp.asarray(gt), jnp.asarray(valid), jcfg)
    np.testing.assert_allclose(sw.numpy(), np.asarray(rsw), rtol=0,
                               atol=1e-6)
    assert sw.numpy()[~valid].min() == 3.0


# ---------------------------------------------------------------------------
# train-mode BatchNorm and the optimizer
# ---------------------------------------------------------------------------

def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def test_train_mode_batchnorms_match_flax(rng):
    """Train-mode ``ConvBN`` (a strided 3 x 3 convolution) and the masked
    ``MaskedBatchNorm`` against Flax's with ``mutable=["batch_stats"]``:
    outputs within 1e-5 and the updated running statistics within 1e-5
    (float32 statistics over 2 x 16 x 16 pixels or 3000 rows, summed in
    another order); eval mode afterwards uses the updated statistics."""
    x = rng.normal(0.3, 1.2, (2, 32, 32, 8)).astype(np.float32)
    jm = jmodel.ConvBN(12, 3, 2, bn_momentum=0.9)
    variables = _perturb(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    ref, upd = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    tm = tmodel.ConvBN(8, 12, 3, 2, momentum=0.9)
    tm.load_state_dict(tpp.pillars_state_from_flax(variables))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["mean"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["var"]),
                               rtol=0, atol=1e-5)
    assert not np.allclose(tm.bn.running_var.numpy(),
                           variables["batch_stats"]["bn"]["var"])
    evald = jm.apply({"params": variables["params"], **upd}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(
            tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1).numpy(), np.asarray(evald), rtol=0, atol=1e-5)

    rows = rng.normal(0.5, 2.0, (3000, 16)).astype(np.float32)
    mask = rng.uniform(size=3000) > 0.6
    jb = jmodel.MaskedBatchNorm(momentum=0.9)
    bvars = _perturb(jax.tree_util.tree_map(np.asarray, jb.init(
        jax.random.PRNGKey(0), jnp.asarray(rows), jnp.asarray(mask))), rng)
    ref, upd = jb.apply(bvars, jnp.asarray(rows), jnp.asarray(mask),
                        train=True, mutable=["batch_stats"])
    tb = tmodel.MaskedBatchNorm(16, momentum=0.9)
    tb.load_state_dict({"weight": torch.from_numpy(bvars["params"]["scale"]),
                        "bias": torch.from_numpy(bvars["params"]["bias"]),
                        "running_mean": torch.from_numpy(
                            bvars["batch_stats"]["mean"]),
                        "running_var": torch.from_numpy(
                            bvars["batch_stats"]["var"])})
    got = tb(torch.from_numpy(rows), torch.from_numpy(mask), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    for key, buf in (("mean", tb.running_mean), ("var", tb.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=0, atol=1e-5)


def test_adamw_matches_optax(rng):
    """``adamw_update`` against ``optax.adamw(2e-3, weight_decay=1e-4)``
    over 5 steps of seeded gradients, on a tree of kernels, biases and
    scales: parameters and moments within 1e-7 (the same float32
    operations; the bias corrections rounded from float64 as optax's under
    JAX's 64-bit mode)."""
    shapes = {"a.weight": (16, 9), "a.bias": (16,), "bn.weight": (16,),
              "c.weight": (4, 16, 3, 3)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    tx = optax.adamw(2e-3, weight_decay=1e-4)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttrain.AdamWState.zeros(tparams)
    for _ in range(5):
        grads = {k: rng.normal(0, 0.5, s).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in
                                 grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = ttrain.adamw_update(
            tparams, {k: torch.from_numpy(v) for k, v in grads.items()},
            tstate, 2e-3, 1e-4)
    assert tstate.count == int(jstate[0].count) == 5
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tstate.mu[k].numpy(),
                                   np.asarray(jstate[0].mu[k]), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(tstate.nu[k].numpy(),
                                   np.asarray(jstate[0].nu[k]), rtol=0,
                                   atol=1e-7)
        assert not np.array_equal(tparams[k].numpy(), params[k])


# ---------------------------------------------------------------------------
# one full training step from JAX's initial variables
# ---------------------------------------------------------------------------

def _load_variables(model, variables):
    model.load_state_dict(tpp.pillars_state_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return model


def _capture_grads():
    """An optax transformation that passes the gradients through and keeps
    them as its state, so that the JAX package's own ``_train_step``
    returns them in its optimizer state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_state(tx, init_vars):
    from lidar_object_detection_tpu.parallel.train import TrainState

    return TrainState(variables=init_vars,
                      opt_state=tx.init(init_vars["params"]),
                      step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_training_step_matches_jax(monkeypatch, head):
    """Three steps of JAX's ``_train_step`` (the JAX package's jitted step,
    its AdamW chained after a pass-through that keeps the gradients) and
    of the port's trainer, both from JAX's ``PillarsTrainer`` initial
    variables (carried across by patching the port trainer's
    initializer), ``assign_iou="aabb"`` (the rotated assigner is held
    above): step 1's loss parts within 1e-4 relative, its per-tensor
    gradients within 1e-4 of the tensor's largest (a float32 network's
    gradients summed in another order), the running statistics after it
    within 1e-5, the losses of steps 2 and 3 within 1e-4 relative.  The
    center head then runs ``_center_curve`` through the same compiled
    step."""
    import functools

    from lidar_object_detection_tpu.models.pointpillars import (
        train as jtrain)
    from lidar_object_detection_tpu.parallel.mesh import make_mesh

    jcfg, tcfg = configs(head, assign_iou="aabb")
    rng = np.random.default_rng(21)
    gt, valid = gt_boxes(rng, anchors_of(tcfg).numpy())
    pts, pv = car_cloud(rng, gt, valid)
    pv[:, -200:] = False
    cls = np.zeros((B, G), np.int32)
    jtrainer = jpp.PillarsTrainer(jcfg, make_mesh(jax.devices()[:1]),
                                  num_points=P)
    init_vars = jtrainer.state.variables
    monkeypatch.setattr(ttrain, "initialize",
                        lambda model, seed: _load_variables(model, init_vars))
    tx = optax.chain(_capture_grads(), jtrainer.tx)
    jstep = jax.jit(functools.partial(jtrain._train_step,
                                      model=jtrainer.model, tx=tx, cfg=jcfg))
    jstate = _jax_state(tx, init_vars)
    trainer = ttrain.PillarsTrainer(tcfg, device="cpu")
    batch = [jnp.asarray(a) for a in (pts, pv, gt, cls, valid)]
    jhist, thist = [], []
    for step in range(3):
        if step == 0:
            tb = trainer.batch_tensors(pts, pv, gt, cls, valid)
            tparts = trainer.loss(*tb)
            tgrads = trainer.gradients(tparts["loss"])
            trainer.update(tgrads)
            tm = {k: v.detach() for k, v in tparts.items()}
        else:
            tm = trainer.train_step(pts, pv, gt, cls, valid)
        jstate, jm = jstep(jstate, *batch)
        jhist.append(float(jm["loss"]))
        thist.append(float(tm["loss"]))
        if step:
            continue
        assert float(tm["num_pos"]) == float(jm["num_pos"]) >= 4
        for key in ("loss", "cls", "box", "dir"):
            assert _rel(tm[key], jm[key]) <= 1e-4 or \
                float(jm[key]) == float(tm[key]) == 0, key
        flat_j = dict(jax.tree_util.tree_flatten_with_path(
            jstate.opt_state[0])[0])
        flat_t = dict(jax.tree_util.tree_flatten_with_path(
            tpp.pillars_flax_from_state(tgrads)["params"])[0])
        assert flat_j.keys() == flat_t.keys()
        for path, ref in flat_j.items():
            ref = np.asarray(ref)
            scale = np.abs(ref).max()
            np.testing.assert_allclose(flat_t[path], ref, rtol=0,
                                       atol=1e-4 * max(scale, 1e-12),
                                       err_msg=str(path))
        stats = dict(jax.tree_util.tree_flatten_with_path(
            tpp.pillars_flax_from_state(
                trainer.model.state_dict())["batch_stats"])[0])
        for path, ref in jax.tree_util.tree_flatten_with_path(
                jstate.variables["batch_stats"])[0]:
            np.testing.assert_allclose(stats[path], np.asarray(ref), rtol=0,
                                       atol=1e-5, err_msg=str(path))
    for t, j in zip(thist, jhist):
        assert _rel(t, j) <= 1e-4, (thist, jhist)
    assert thist[2] < thist[0]
    assert trainer.state.step == 3 and trainer.state.opt_state.count == 3
    assert int(jstate.step) == 3
    if head == "center":
        _center_curve(tcfg, init_vars, tx, jstep)


# the center head's 4-step curve: each step's loss within CENTER_CURVE_RTOL
# relative of JAX's, the limit of the later steps above.  Read at this
# size: 9.7e-8, 1.1e-7, 3.4e-7 and 2.6e-6 (the losses go 19.63 -> 16.69 ->
# 16.89 -> 16.13, up and down): float32 steps summed in another order
# than XLA's, the difference growing with each step
CENTER_CURVE_RTOL = 1e-4


def _center_curve(tcfg, init_vars, tx, jstep):
    """The port trains as JAX trains, whichever way the loss goes: four
    center-head steps on four different seeded batches, from JAX's initial
    variables carried into a new port trainer (its initializer patched by
    the caller) and a new JAX state, through the caller's compiled JAX
    step and the port's ``train_step``.  Each step's ``num_pos`` exactly,
    its loss within CENTER_CURVE_RTOL relative."""
    trainer = ttrain.PillarsTrainer(tcfg, device="cpu")
    jstate = _jax_state(tx, init_vars)
    rng = np.random.default_rng(31)
    anchors = anchors_of(tcfg).numpy()
    jcurve, tcurve, npos = [], [], []
    for step in range(4):
        gt, valid = gt_boxes(rng, anchors)
        valid[0, 4 + step % 2:] = False       # 10 or 11 GTs a batch
        pts, pv = car_cloud(rng, gt, valid)
        pv[:, -rng.integers(1, 400):] = False
        batch = (pts, pv, gt, np.zeros((B, G), np.int32), valid)
        tm = trainer.train_step(*batch)
        jstate, jm = jstep(jstate, *(jnp.asarray(a) for a in batch))
        assert float(tm["num_pos"]) == float(jm["num_pos"]) >= 8, step
        npos.append(float(jm["num_pos"]))
        jcurve.append(float(jm["loss"]))
        tcurve.append(float(tm["loss"]))
    for t, j in zip(tcurve, jcurve):
        assert _rel(t, j) <= CENTER_CURVE_RTOL, (tcurve, jcurve)
    assert len(set(npos)) == 2 and trainer.state.step == 4


# ---------------------------------------------------------------------------
# augmentation, weights, the initializer
# ---------------------------------------------------------------------------

def _frames(rng, n=3, cars=5, per_box=40, clutter=1500):
    """(points (N, 4), boxes7 (cars, 7)) frames: points inside each car
    box and clutter around them."""
    out = []
    for _ in range(n):
        boxes = np.stack([rng.uniform(-20, 20, cars),
                          rng.uniform(-20, 20, cars), np.full(cars, -1.0),
                          rng.uniform(1.5, 2.0, cars),
                          rng.uniform(3.5, 4.8, cars),
                          rng.uniform(1.4, 1.7, cars),
                          rng.uniform(-np.pi, np.pi, cars)], 1).astype(
            np.float32)
        chunks = []
        for x, y, z, w, l, h, yaw in boxes:
            u = rng.uniform(-0.45, 0.45, (per_box, 3))
            c, s = np.cos(yaw), np.sin(yaw)
            chunks.append(np.stack([x + u[:, 0] * l * c - u[:, 1] * w * s,
                                    y + u[:, 0] * l * s + u[:, 1] * w * c,
                                    z + u[:, 2] * h], 1))
        chunks.append(np.stack([rng.uniform(-25, 25, clutter),
                                rng.uniform(-25, 25, clutter),
                                rng.uniform(-2.5, 0.5, clutter)], 1))
        xyz = np.concatenate(chunks)
        pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1))], 1)
        out.append((pts.astype(np.float32), boxes))
    return out


def test_augmentation_matches_jax_bit_for_bit():
    """``GtDatabase.build``, ``sample_paste``, ``global_augment`` and
    ``augment_frame`` under the same ``default_rng`` seed give the JAX
    package's arrays bit for bit (the same NumPy code)."""
    frames = _frames(np.random.default_rng(4))
    tdb = taug.GtDatabase.build(frames, min_points=8)
    jdb = jaug.GtDatabase.build(frames, min_points=8)
    assert len(tdb) == len(jdb) >= 8
    for a, b in zip(tdb.samples, jdb.samples):
        np.testing.assert_array_equal(a.box7, b.box7)
        np.testing.assert_array_equal(a.points, b.points)
    pts, boxes = frames[0]
    for seed in (0, 1, 2):
        got = taug.sample_paste(pts, boxes, tdb,
                                np.random.default_rng(seed), max_samples=4)
        ref = jaug.sample_paste(pts, boxes, jdb,
                                np.random.default_rng(seed), max_samples=4)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        got = taug.global_augment(pts, boxes, np.random.default_rng(seed))
        ref = jaug.global_augment(pts, boxes, np.random.default_rng(seed))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        got = taug.augment_frame(pts, boxes, tdb,
                                 np.random.default_rng(seed), max_samples=6)
        ref = jaug.augment_frame(pts, boxes, jdb,
                                 np.random.default_rng(seed), max_samples=6)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        assert len(got[1]) > len(boxes)
    assert taug.augment_frame(pts, boxes, None,
                              np.random.default_rng(0))[0].shape == pts.shape


@pytest.fixture(scope="module")
def full_width_init():
    """Flax's initial variables of the full-width network (both heads; the
    parameters do not depend on the grid's extent)."""
    grid = dict(x_range=(-10.24, 10.24), y_range=(-10.24, 10.24),
                z_range=(-5.0, 1.5), pillar_size=0.32)
    out = {}
    for head in ("ssd", "center"):
        jcfg = jpp.PillarsConfig(grid=jpp.PillarGridConfig(**grid),
                                 head=head)
        tcfg = tpp.PillarsConfig(grid=tpp.PillarGridConfig(**grid),
                                 head=head)
        pts = jnp.zeros((1, 256, 4), jnp.float32)
        pv = jnp.zeros((1, 256), bool)
        variables = jax.jit(jpp.PointPillars(jcfg).init)(
            jax.random.PRNGKey(0), pts, pv)
        out[head] = (tcfg, jax.tree_util.tree_map(np.asarray, variables))
    return out


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_weights_round_trip_bit_exact(full_width_init, head):
    """``pillars_flax_from_state`` inverts ``pillars_state_from_flax`` bit
    for bit, both ways, the transposed kernels' flips included."""
    tcfg, variables = full_width_init[head]
    sd = tpp.pillars_state_from_flax(variables)
    back = tpp.pillars_flax_from_state(sd)
    flat = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for path, value in flat.items():
        assert flat_back[path].dtype == value.dtype
        np.testing.assert_array_equal(flat_back[path], value)
    model = tpp.PointPillars(tcfg)
    tinit.initialize(model, seed=3)
    sd = model.state_dict()
    again = tpp.pillars_state_from_flax(tpp.pillars_flax_from_state(sd))
    assert sd.keys() == again.keys()
    for key, value in sd.items():
        assert torch.equal(again[key], value), key


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_initializer_matches_flax_distributions(full_width_init, head):
    """The port's initializer at full width against Flax's defaults:
    every kernel's standard deviation within 10 % of Flax's draw of the
    same tensor (576 to 295,000 draws a tensor), mean near 0 and no value
    past two of its standard deviations; BatchNorm scales 1, biases 0,
    statistics 0 and 1; the heat bias exactly -2.19; the same seed gives
    the same bits, another seed other bits."""
    tcfg, variables = full_width_init[head]
    model = tinit.initialize(tpp.PointPillars(tcfg), seed=0)
    got = dict(jax.tree_util.tree_flatten_with_path(
        tpp.pillars_flax_from_state(model.state_dict()))[0])
    n_kernels = 0
    for path, ref in jax.tree_util.tree_flatten_with_path(variables)[0]:
        value = got[path]
        assert value.shape == ref.shape, path
        leaf = path[-1].key
        if leaf == "kernel":
            n_kernels += 1
            fan_in = int(np.prod(ref.shape[:-1]))
            std = np.sqrt(1.0 / fan_in) / TRUNCATED_STD
            assert abs(value.std() / ref.std() - 1) < 0.10, path
            assert abs(value.mean()) < 0.1 * std, path
            assert np.abs(value).max() <= 2 * std * (1 + 1e-6), path
        else:
            np.testing.assert_array_equal(value, ref, err_msg=str(path))
    assert n_kernels >= 20
    if head == "center":
        assert (model.center_head.heat.bias.detach().numpy()
                == np.float32(-2.19)).all()
    again = tinit.initialize(tpp.PointPillars(tcfg), seed=0)
    other = tinit.initialize(tpp.PointPillars(tcfg), seed=1)
    for (k, a), b, c in zip(model.state_dict().items(),
                            again.state_dict().values(),
                            other.state_dict().values()):
        assert torch.equal(a, b), k
        if a.dim() >= 2:
            assert not torch.equal(a, c), k


def test_train_forward_uses_batch_statistics(rng):
    """``PointPillars(..., train=True)`` is no longer refused: it
    normalizes with the batch's statistics and moves the running ones,
    which ``train=False`` leaves alone."""
    _, tcfg = configs()
    model = tinit.initialize(tpp.PointPillars(tcfg), seed=0)
    gt, valid = gt_boxes(rng, anchors_of(tcfg).numpy())
    pts, pv = car_cloud(rng, gt, valid)
    pts, pv = torch.from_numpy(pts), torch.from_numpy(pv)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model(pts, pv)
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    out = model(pts, pv, train=True)
    assert out["cls"].shape == (B, *HEAD_HW, 2, 1)
    assert out["cls"].requires_grad
    moved = [k for k, v in model.state_dict().items()
             if k.endswith("running_var") and not torch.equal(before[k], v)]
    assert len(moved) == len([k for k in before if k.endswith(
        "running_var")])


def test_trainer_dataclass_fields_match_jax_config():
    """The port's ``PillarsConfig`` has the JAX config's fields, in its
    order and with its defaults."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jpp.PillarsConfig)
          if f.name != "grid"]
    tf = [(f.name, f.default) for f in dataclasses.fields(tpp.PillarsConfig)
          if f.name != "grid"]
    assert tf == jf
