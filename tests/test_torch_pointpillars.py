"""The port's PointPillars modules against the JAX package's, on the same
seeded numpy inputs: voxelization, the network with both heads (random
weights at the JAX tests' TINY size, and the committed surround
checkpoints on a 64 x 64 grid), the weight reader, and the decodes.

Tolerances, stated per check:
- pillar ids, grid masks and the BEV scatter's max: exact; the 9 point
  features within 1e-5 (the pillar means are float sums in another
  order);
- network heads within 1e-4, TINY and the committed weights at full
  width alike (the latter's 16 convolutions of up to 3456 terms, summed
  in another order, differ by up to 1.7e-5 on logits of up to 22);
- decodes fed the same raw heads: classes, validity and the chosen
  anchors exact, boxes within 1e-5 (2e-5 for exp'd sizes and atan2),
  scores within 1e-6;
- weights: bit for bit, after the stated layout change.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn
from flax import serialization

from lidar_object_detection_tpu.models import pointpillars as jpp
from lidar_object_detection_tpu.models.pointpillars import augment as jaug
from lidar_object_detection_tpu.models.pointpillars import center as jcenter
from lidar_object_detection_tpu_torch.models import pointpillars as tpp
from lidar_object_detection_tpu_torch.models.pointpillars import (
    augment as taug)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    center as tcenter)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    model as tmodel)
from lidar_object_detection_tpu_torch.models.pointpillars import (
    weights as tweights)
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {head: os.path.join(REPO, "checkpoints",
                            f"pp_{head}_surround.msgpack")
         for head in ("ssd", "center")}

TINY_GRID = dict(x_range=(0.0, 20.48), y_range=(-10.24, 10.24),
                 pillar_size=0.32)
TINY = dict(embed_dim=16, backbone_channels=(16, 32, 64),
            backbone_layers=(1, 1, 1), up_channels=16)
# the surround checkpoints' z range and pillar size on a +-10.24 m square
SMALL_GRID = dict(x_range=(-10.24, 10.24), y_range=(-10.24, 10.24),
                  z_range=(-5.0, 1.5), pillar_size=0.32)


def configs(grid, head="ssd", **kw):
    """The same PillarsConfig in both packages."""
    return (jpp.PillarsConfig(grid=jpp.PillarGridConfig(**grid), head=head,
                              **kw),
            tpp.PillarsConfig(grid=tpp.PillarGridConfig(**grid), head=head,
                              **kw))


def random_points(rng, batch, p, grid):
    """(B, P, 4) float32 points over and around the grid, and a mask."""
    (x0, x1), (y0, y1) = grid["x_range"], grid["y_range"]
    pts = np.zeros((batch, p, 4), np.float32)
    pts[..., 0] = rng.uniform(x0 - 2, x1 + 2, (batch, p))
    pts[..., 1] = rng.uniform(y0 - 2, y1 + 2, (batch, p))
    pts[..., 2] = rng.uniform(-4.0, 2.0, (batch, p))
    pts[..., 3] = rng.uniform(0, 1, (batch, p))
    valid = rng.uniform(0, 1, (batch, p)) > 0.1
    return pts, valid


def car_points(rng, boxes7, per_box=400, ground=3000, extent=10.0):
    """(N, 4) float32: points on the sides and roofs of ``boxes7`` and a
    ground plane: car-shaped clusters (which the checkpoints, trained on
    real multi-sweep clouds, score low)."""
    chunks = []
    for x, y, z, w, l, h, yaw in boxes7:
        u = rng.uniform(-0.5, 0.5, (per_box, 3))
        face = rng.integers(0, 3, per_box)
        u[face == 0, 0] = np.sign(u[face == 0, 0]) * 0.5
        u[face == 1, 1] = np.sign(u[face == 1, 1]) * 0.5
        u[face == 2, 2] = 0.5
        lx, ly, lz = u[:, 0] * l, u[:, 1] * w, u[:, 2] * h
        c, s = np.cos(yaw), np.sin(yaw)
        chunks.append(np.stack([x + lx * c - ly * s, y + lx * s + ly * c,
                                z + lz], 1))
    g = rng.uniform(-extent, extent, (ground, 2))
    chunks.append(np.concatenate([g, np.full((ground, 1), -1.75)], 1))
    xyz = np.concatenate(chunks).astype(np.float32)
    refl = rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)
    return np.concatenate([xyz, refl], 1)


CARS = np.array([[3.0, 2.0, -1.0, 1.7, 4.2, 1.5, 0.3],
                 [3.3, 2.2, -1.0, 1.7, 4.2, 1.5, 0.35],
                 [-5.0, -4.0, -1.0, 1.8, 4.5, 1.6, 1.6],
                 [6.0, -6.0, -0.9, 1.6, 3.9, 1.5, -0.8],
                 [-6.5, 5.5, -1.0, 1.7, 4.0, 1.5, 2.9]], np.float32)


def _perturbed(variables, rng):
    """Random BatchNorm scales, biases and statistics (Flax initializes
    them to 1, 0, 0, 1), so that every BatchNorm is tested."""
    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k == "mean":
                v = rng.normal(0, 0.1, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 2.0, v.shape)
            elif k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias":
                v = rng.normal(0, 0.1, v.shape)
            out[k] = np.asarray(v, np.float32)
        return out
    return walk(variables)


def _port_model(tcfg, variables):
    model = tpp.PointPillars(tcfg)
    model.load_state_dict(tpp.pillars_state_from_flax(variables),
                          strict=True)
    return model.eval()


def _forward_both(jcfg, tcfg, variables, pts, valid):
    ref = jax.jit(jpp.PointPillars(jcfg).apply)(
        variables, jnp.asarray(pts), jnp.asarray(valid))
    with torch.inference_mode():
        got = _port_model(tcfg, variables)(torch.from_numpy(pts),
                                           torch.from_numpy(valid))
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


# ---------------------------------------------------------------------------
# voxelization
# ---------------------------------------------------------------------------

def test_pillar_ids_match_jax(rng):
    jcfg, tcfg = configs(TINY_GRID)
    pts, valid = random_points(rng, 1, 2000, TINY_GRID)
    ids, ok = tpp.pillar_ids(torch.from_numpy(pts[0]),
                             torch.from_numpy(valid[0]), tcfg.grid)
    rids, rok = jpp.pillar_ids(jnp.asarray(pts[0]), jnp.asarray(valid[0]),
                               jcfg.grid)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    assert 300 < int(ok.sum()) < 2000


def test_point_features_and_scatter_match_jax(rng):
    jcfg, tcfg = configs(TINY_GRID)
    pts, valid = random_points(rng, 2, 3000, TINY_GRID)
    flat, fvalid = pts.reshape(-1, 4), valid.reshape(-1)
    feats, ids, ok = tpp.point_features(torch.from_numpy(flat),
                                        torch.from_numpy(fvalid), tcfg.grid,
                                        batch=2)
    rfeats, rids, rok = jpp.point_features(jnp.asarray(flat),
                                           jnp.asarray(fvalid), jcfg.grid,
                                           batch=2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_allclose(feats.numpy(), np.asarray(rfeats), rtol=0,
                               atol=1e-5)
    # frame 1's pillars carry the batch offset
    assert int(ids[3000:].min()) >= 0 and \
        int(ids[3000:][ok[3000:]].min()) >= tcfg.grid.nx * tcfg.grid.ny
    emb = np.maximum(rng.normal(0, 1, (6000, 5)), 0).astype(np.float32)
    bev = tpp.scatter_bev(torch.from_numpy(emb), ids, ok, tcfg.grid,
                          batch=2)
    rbev = jpp.scatter_bev(jnp.asarray(emb), rids, rok, jcfg.grid, batch=2)
    assert bev.shape == (2, 64, 64, 5)
    np.testing.assert_array_equal(bev.numpy(), np.asarray(rbev))


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
def test_transposed_conv_matches_flax(rng, k):
    """Flax's ConvTranspose (SAME, kernel == stride) on an input with no
    symmetry: the port's ConvBN with the flipped kernel equals it, and the
    kernel left unflipped does not."""
    x = rng.normal(0, 1, (1, 5, 7, 3)).astype(np.float32)
    mod = fnn.ConvTranspose(4, (k, k), strides=(k, k), use_bias=False)
    params = mod.init(jax.random.PRNGKey(k), jnp.asarray(x))
    ref = np.asarray(mod.apply(params, jnp.asarray(x)))
    kernel = np.asarray(params["params"]["kernel"])
    layer = tmodel.ConvBN(3, 4, k, k, transpose=True)
    sd = tweights.pillars_state_from_flax(
        {"params": {"backbone": {"up1": {"conv": {"kernel": kernel}}}}})
    layer.conv.weight.data = sd["backbone.up1.conv.weight"]
    got = layer.conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == ref.shape == (1, 5 * k, 7 * k, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    unflipped = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(kernel).permute(2, 3, 0, 1), stride=k)
    assert np.abs(unflipped.permute(0, 2, 3, 1).numpy() - ref).max() > 0.1


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_tiny_network_matches_jax(rng, head):
    jcfg, tcfg = configs(TINY_GRID, head, **TINY)
    pts, valid = random_points(rng, 2, 3000, TINY_GRID)
    variables = jpp.PointPillars(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(valid))
    variables = _perturbed(jax.tree_util.tree_map(np.asarray, variables),
                           rng)
    ref, got = _forward_both(jcfg, tcfg, variables, pts, valid)
    keys = ("heat", "reg") if head == "center" else ("cls", "box", "dir")
    assert sorted(got) == sorted(ref) == sorted(keys)
    for k in keys:
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def committed():
    """The committed checkpoints' variables, read by the port's reader."""
    return {head: read_flax_msgpack(path)["0"]
            for head, path in CKPTS.items()}


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_committed_weights_load_bit_exact(committed, head):
    """The port's reader and ``pillars_state_from_flax`` give flax's own
    restore of the file, bit for bit, after the layout change; the state
    dict loads strictly into the surround model."""
    with open(CKPTS[head], "rb") as f:
        restored = serialization.msgpack_restore(f.read())["0"]
    sd = tpp.pillars_state_from_flax(committed[head])
    model = tpp.PointPillars(dataclasses.replace(
        tpp.PillarsConfig.kitti360_surround(), head=head))
    model.load_state_dict(sd, strict=True)
    n = 0
    for (collection, *path), ref in _leaves(restored):
        stem = ".".join(path[:-1])
        leaf = path[-1]
        ref = np.asarray(ref)
        if collection == "batch_stats":
            got = sd[f"{stem}.running_{leaf}"].numpy()
        elif leaf == "kernel":
            got = sd[f"{stem}.weight"].numpy()
            if ref.ndim == 2:
                got = got.T
            elif stem in ("backbone.up1.conv", "backbone.up2.conv"):
                got = got[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                got = got.transpose(2, 3, 1, 0)
        else:
            got = sd[f"{stem}.{'weight' if leaf == 'scale' else leaf}"]
            got = got.numpy()
        assert got.dtype == ref.dtype == np.float32
        assert got.tobytes() == np.ascontiguousarray(ref).tobytes(), path
        n += 1
    assert n == len(sd) == len(model.state_dict())


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("head", ["ssd", "center"])
def test_committed_network_matches_jax_on_small_grid(rng, committed, head):
    """The trained weights at full width on a 64 x 64 grid (the
    convolutions do not depend on the grid's extent)."""
    jcfg, tcfg = configs(SMALL_GRID, head)
    pts = car_points(rng, CARS)[None]
    valid = np.ones(pts.shape[:2], bool)
    ref, got = _forward_both(jcfg, tcfg, committed[head], pts, valid)
    for k in ref:
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4)
    # the heads respond to the scene
    logits = ref["heat"] if head == "center" else ref["cls"]
    assert logits.std() > 0.5


def test_training_is_refused(rng):
    _, tcfg = configs(TINY_GRID, **TINY)
    pts, valid = random_points(rng, 1, 100, TINY_GRID)
    with pytest.raises(NotImplementedError, match="item 7"):
        tpp.PointPillars(tcfg)(torch.from_numpy(pts),
                               torch.from_numpy(valid), train=True)


# ---------------------------------------------------------------------------
# decoding, fed the same raw heads
# ---------------------------------------------------------------------------

def _committed_heads(rng, committed, head):
    jcfg, tcfg = configs(SMALL_GRID, head)
    pts = car_points(rng, CARS)[None]
    out = jax.jit(jpp.PointPillars(jcfg).apply)(
        committed[head], jnp.asarray(pts), jnp.asarray(np.ones((1, len(
            pts[0])), bool)))
    return jcfg, tcfg, {k: np.asarray(v[0]) for k, v in out.items()}


def _compare_dets(got, ref, box_atol=2e-5):
    ok = np.asarray(ref["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), ok)
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(ref["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["boxes7"].numpy()[ok],
                               np.asarray(ref["boxes7"])[ok], rtol=0,
                               atol=box_atol)
    return int(ok.sum())


@pytest.mark.parametrize("rotated", [True, False])
def test_ssd_decode_matches_jax(rng, committed, rotated):
    jcfg, tcfg, heads = _committed_heads(rng, committed, "ssd")
    # a low threshold, so that suppression has candidates to work on
    kw = dict(score_threshold=0.004, rotated_nms=rotated)
    ref = jpp.decode_predictions({k: jnp.asarray(v)
                                  for k, v in heads.items()}, jcfg, **kw)
    before = dict(kernel_lib.LAUNCHES)
    got = tpp.decode_predictions({k: torch.from_numpy(v)
                                  for k, v in heads.items()}, tcfg, **kw)
    assert kernel_lib.LAUNCHES == before       # the CPU runs the twins
    n = _compare_dets(got, ref)
    assert 3 <= n < 64


@pytest.mark.parametrize("rotated", [True, False])
def test_ssd_decode_ties_take_lowest_index(rng, rotated):
    """Equal logits over most anchors (an empty scene): top-k takes them
    lowest index first, as jax.lax.top_k does."""
    jcfg, tcfg = configs(TINY_GRID, **TINY)
    h, w, a = 32, 32, 2
    cls = np.full((h, w, a, 1), 0.5, np.float32)
    cls[rng.integers(0, h, 20), rng.integers(0, w, 20), 0, 0] = 2.0
    heads = {"cls": cls,
             "box": rng.normal(0, 0.3, (h, w, a, 7)).astype(np.float32),
             "dir": rng.normal(0, 1, (h, w, a, 2)).astype(np.float32)}
    kw = dict(score_threshold=0.3, rotated_nms=rotated)
    ref = jpp.decode_predictions({k: jnp.asarray(v)
                                  for k, v in heads.items()}, jcfg, **kw)
    got = tpp.decode_predictions({k: torch.from_numpy(v)
                                  for k, v in heads.items()}, tcfg, **kw)
    assert _compare_dets(got, ref) == 64


def test_center_decode_matches_jax(rng, committed):
    jcfg, tcfg, heads = _committed_heads(rng, committed, "center")
    for thr in (0.3, 0.02):
        ref = jcenter.decode_center({k: jnp.asarray(v)
                                     for k, v in heads.items()}, jcfg,
                                    score_threshold=thr)
        got = tpp.decode_predictions({k: torch.from_numpy(v)
                                      for k, v in heads.items()}, tcfg,
                                     score_threshold=thr)
        n = _compare_dets(got, ref)
        assert n >= 3 or thr == 0.3
    # zero-heavy heatmaps: most cells are not peaks and tie at 0
    flat = np.full_like(heads["heat"], -9.0)
    flat[5, 7, 0] = 3.0
    ref = jcenter.decode_center({"heat": jnp.asarray(flat),
                                 "reg": jnp.asarray(heads["reg"])}, jcfg)
    got = tcenter.decode_center({"heat": torch.from_numpy(flat),
                                 "reg": torch.from_numpy(heads["reg"])},
                                tcfg)
    _compare_dets(got, ref)


def test_box_conversions_match_jax(rng):
    boxes = np.concatenate([CARS, CARS + np.float32(0.5)])
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, len(boxes))
    corners = tpp.boxes7_to_corners(torch.from_numpy(boxes)).numpy()
    rcorners = np.asarray(jpp.boxes7_to_corners(jnp.asarray(boxes)))
    np.testing.assert_allclose(corners, rcorners, rtol=0, atol=1e-5)
    back = tpp.corners_to_boxes7(torch.from_numpy(rcorners)).numpy()
    rback = np.asarray(jpp.corners_to_boxes7(jnp.asarray(rcorners)))
    np.testing.assert_allclose(back, rback, rtol=0, atol=2e-5)
    np.testing.assert_allclose(back, boxes, rtol=0, atol=1e-4)
    aabb = tpp.bev_aabb(torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(aabb, np.asarray(jpp.bev_aabb(
        jnp.asarray(boxes))), rtol=0, atol=1e-5)
    anchors = tpp.anchor_grid(configs(TINY_GRID)[1]).numpy()
    np.testing.assert_array_equal(anchors, np.asarray(jpp.anchor_grid(
        configs(TINY_GRID)[0])))


def test_points_in_box7_matches_jax(rng):
    pts = car_points(rng, CARS, ground=500)
    pts[:200, :3] += rng.normal(0, 0.05, (200, 3)).astype(np.float32)
    for box in CARS:
        for margin in (0.0, 0.2):
            got = taug.points_in_box7(pts, box, margin)
            np.testing.assert_array_equal(
                got, jaug.points_in_box7(pts, box, margin))
    assert taug.points_in_box7(pts, CARS[0]).sum() > 100
