"""The port's YOLO trainer over a (data, model) mesh
(``parallel/train.py`` ``YoloTrainer(..., mesh=...)``,
``param_shardings``; the synced train-mode BatchNorm of
``models/common.py`` and the global loss normalisers through
``parallel/collectives.py``) on CPU ranks over gloo, against the JAX
package's trainer on its (4, 2) mesh and against the port's one-process
step.

The ranks import no JAX (this module imports it inside the fixtures that
compute references, so that a rank can import its rank functions); one
JAX step is compiled for the file.

Cases and tolerances (each test's docstring says why):
- detection only, JAX's config of ``tests/test_parallel.py:115-120`` (n,
  8 classes, no mask head, 64 x 64, B = 4, JAX's initial variables): one
  step of JAX's trainer on the 8-device (4, 2) mesh against the port at
  world 2 (data 2) and world 4 (2 x 2, kernels sliced over ``model``):
  loss parts within 1e-4 relative; every gradient, updated BatchNorm
  statistic and AdamW moment within STEP_TOL = 1e-3 of its tensor's
  largest entry (the one-process port against JAX in
  ``tests/test_torch_yolo_train.py`` is held to the same; the gradients
  measured within 3.0e-4 at both worlds), but the three
  gradients that are 0 but for rounding (``chip_smoke.
  YOLO_ZERO_GRAD_LEAVES``), held within ``YOLO_ZERO_GRAD_SHARE`` of the
  step's largest gradient on both sides; the parameters' first Adam
  update as that file's ``check_update`` holds it; world 2 and world 4
  bit for bit equal (slicing a kernel changes no arithmetic);
- segment on (the committed n variables, 80 classes, the mask loss,
  64 x 128 crops, B = 4): the port at world 2 against the port in one
  process, loss parts within SYNC_PARTS_RTOL = 2e-5 relative and
  gradients within SYNC_TOL = 2e-4 of each tensor's largest (only the
  sums of the BatchNorm statistics and of the normalisers split in two;
  measured 4.4e-6 and 4.5e-5); a
  DistributedDataParallel-style step on the same ranks (each rank's
  local BatchNorm statistics and local normalisers, the gradients
  averaged) must miss that limit by far;
- the world of one with a mesh is the one-process trainer bit for bit;
- ``param_shardings``: the parameters JAX's ``param_shardings`` shards on
  the YOLO11n-seg tree at tp = 2 and 4, each on the dim holding the
  Flax kernel's last axis, each rank's slice the values of JAX's shard.
"""

import functools
import os

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu_torch.models.yolo import (
    weights as tweights)
from lidar_object_detection_tpu_torch.models.yolo.model import (
    Yolo11, YoloConfig)
from lidar_object_detection_tpu_torch.models.yolo.weights import (
    flax_kernel_axes, from_flax_variables, yolo_flax_from_state)
from lidar_object_detection_tpu_torch.parallel import distributed
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack)

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(os.path.dirname(HERE), "checkpoints",
                    "yolo11n_seg_distill.msgpack")
STEP_TOL = 1e-3
SYNC_TOL = 2e-4
SYNC_PARTS_RTOL = 2e-5
TIMEOUT = 300
ZERO_LEAVES = set(chip_smoke.YOLO_ZERO_GRAD_LEAVES)
DET = dict(scale="n", num_classes=8, segment=False)


def det_batch():
    """``tests/test_parallel.py``'s batch: 4 random 64 x 64 images, two
    targets each."""
    images = np.random.default_rng(0).random((4, 64, 64, 3), np.float32)
    targets = {
        "boxes": np.tile(np.array([[[8, 8, 40, 40], [20, 20, 60, 56]]],
                                  np.float32), (4, 1, 1)),
        "classes": np.tile(np.array([[2, 5]], np.int32), (4, 1)),
        "valid": np.ones((4, 2), bool),
    }
    return images, targets


def seg_batch():
    """4 crops (64 x 128) of the committed camera frames and seeded
    targets with masks at prototype resolution."""
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    frames = [read_png_rgb(p).astype(np.float32) / 255
              for p in chip_smoke.FRAMES]
    images = np.stack([frames[i % 2][180 + 40 * i:244 + 40 * i,
                                     500 + 150 * i:628 + 150 * i]
                       for i in range(4)]).astype(np.float32)
    rng = np.random.default_rng(11)
    boxes = np.zeros((4, 6, 4), np.float32)
    valid = np.zeros((4, 6), bool)
    for i in range(4):
        for j in range(4):
            bw, bh = rng.uniform(10, 76), rng.uniform(8, 44)
            x0, y0 = rng.uniform(0, 128 - bw), rng.uniform(0, 64 - bh)
            boxes[i, j] = (x0, y0, x0 + bw, y0 + bh)
            valid[i, j] = True
    targets = {"boxes": boxes, "valid": valid,
               "classes": rng.choice([2, 5, 7], (4, 6)).astype(np.int32),
               "masks": (rng.random((4, 6, 16, 32)) > 0.4).astype(
                   np.float32)}
    return images, targets


def flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = np.asarray(v)
    return out


def copy_tree(tree):
    return {k: copy_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in tree.items()}


def scaled_errors(got, ref, skip=()):
    """Each tensor's largest difference in units of its ``ref``
    tensor's largest entry, but the leaves in ``skip``."""
    got, ref = flat(got), flat(ref)
    assert got.keys() == ref.keys()
    return {k: float(np.abs(got[k].astype(np.float64) - r).max())
            / max(float(np.abs(r).max()), 1e-30)
            for k, r in ref.items() if k not in skip}


def zero_share(grads):
    g = flat(grads)
    largest = max(float(np.abs(v).max()) for v in g.values())
    return max(float(np.abs(g[k]).max()) for k in ZERO_LEAVES) / largest


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def check_update(got, ref, start, grads, ref_grads, step):
    """Adam's first update against JAX's, as ``tests/test_torch_yolo_train
    .py`` holds it: ``-step * (u + wd * p)`` with ``u = g / (|g| + eps)``,
    so the two updates differ by what their gradients' ``u`` differ by,
    times the step, within 1e-3 of the step plus two ulps; returns the
    count of elements whose ``u`` differ by more than 1e-3."""
    got, ref, start = flat(got), flat(ref), flat(start)
    grads, ref_grads = flat(grads), flat(ref_grads)
    u = lambda g: g.astype(np.float64) / (np.abs(g.astype(np.float64))
                                          + 1e-8)
    moved = 0
    for key, r in ref.items():
        du = u(grads[key]) - u(ref_grads[key])
        moved += int((np.abs(du) > 1e-3).sum())
        err = ((got[key] - start[key]).astype(np.float64)
               - (r - start[key]) + step * du)
        slack = 2 * np.spacing(np.abs(start[key]) + step)
        assert (np.abs(err) <= 1e-3 * step + slack).all(), key
    return moved


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _step(tr, images, targets, ddp=False):
    """One step in the trainer's pieces: returns (the whole batch's loss
    parts, the full gradients as a Flax tree).  ``ddp``: each rank's
    loss on its rows with the one-card trainer's local statistics and
    normalisers, gradients averaged over the ranks."""
    import torch.distributed as dist

    from lidar_object_detection_tpu_torch.models import common
    from lidar_object_detection_tpu_torch.parallel import collectives

    imgs, tg = tr.local_batch(*tr.put(images, targets))
    if ddp:
        group, tr.data_group = tr.data_group, None
        common.split_batch(tr.model, None)
        loss, parts = tr.loss(imgs, tg)
        grads = tr.gradients(loss)
        tr.data_group = group
        common.split_batch(tr.model, group)
        n = torch.tensor(float(dist.get_world_size(group)))
        grads = {k: v / n for k, v in zip(grads, collectives.
                 all_reduce_coalesced(list(grads.values()), group))}
        parts = {k: v / n for k, v in parts.items()}
        loss = loss / n
    else:
        loss, parts = tr.loss(imgs, tg)
        grads = tr.gradients(loss)
    shares = {"loss": loss, **parts}
    total = collectives.all_reduce_coalesced(
        [v.detach() for v in shares.values()], tr.data_group)
    tr.update(grads)
    return ({k: float(v) for k, v in zip(shares, total)},
            yolo_flax_from_state(tr.full_tree(grads),
                                 tr.cfg.segment)["params"])


def rank_det_step(variables, world):
    """The detection-only step at ``world`` ranks (model 2 at 4); also
    ``param_shardings`` of the YOLO11n-seg network at tp = 2 and 4."""
    from lidar_object_detection_tpu_torch.parallel import (
        make_mesh, param_shardings)
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer

    mp = 1 if world == 2 else 2
    mesh = make_mesh("cpu", mp)
    tr = YoloTrainer(YoloConfig(**DET), image_size=(64, 64), max_targets=2,
                     device="cpu", mesh=mesh)
    tr.load(variables)
    images, targets = det_batch()
    parts, grads = _step(tr, images, targets)
    # copies: on the CPU the trees' arrays share the live tensors' memory
    out = {"parts": parts, "grads": grads,
           "variables": copy_tree(tr.variables()),
           "opt": copy_tree(tr.opt_state_dict()),
           "held": {k: tuple(v.shape) for k, v in tr.state.params().items()
                    if k in tr.shard_dims},
           "step2": float(tr.train_step(images, targets)["loss"])}
    if world == 4:
        seg = Yolo11(YoloConfig(scale="n"))
        out["rules"] = {tp: param_shardings(make_mesh("cpu", tp), seg)
                        for tp in (2, 4)}
    return out


def rank_seg_step(ddp):
    from lidar_object_detection_tpu_torch.parallel import make_mesh
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer

    tr = YoloTrainer(YoloConfig(scale="n"), image_size=(64, 128),
                     max_targets=6, device="cpu", mesh=make_mesh("cpu"))
    tr.load(read_flax_msgpack(CKPT)["variables"])
    return _step(tr, *seg_batch(), ddp=ddp)


def rank_world_of_one():
    from lidar_object_detection_tpu_torch.parallel import make_mesh
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer

    out = []
    for mesh in (None, make_mesh("cpu")):
        tr = YoloTrainer(YoloConfig(scale="n"), image_size=(64, 128),
                         max_targets=6, device="cpu", mesh=mesh,
                         ema_decay=0.9)
        tr.load(read_flax_msgpack(CKPT)["variables"])
        m = [tr.train_step(*seg_batch()) for _ in range(2)]
        out.append(({k: float(v) for k, v in m[-1].items()},
                    *map(copy_tree, (tr.variables(), tr.ema_variables(),
                                     tr.opt_state_dict()))))
    return out


def spawn(target, world, args, tmp):
    return [r.value for r in distributed.spawn(
        f"test_torch_scale_out_yolo:{target}", world, args, timeout=TIMEOUT,
        device="cpu", path=[HERE], workdir=str(tmp))]


# ---------------------------------------------------------------------------
# against JAX's trainer on its mesh
# ---------------------------------------------------------------------------

def _capture_grads():
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def det_case(tmp_path_factory):
    """One step of JAX's ``YoloTrainer`` on the (4, 2) mesh (its jitted
    ``_train_step`` with the gradients kept, the batch over ``data`` and
    the kernels over ``model`` as its ``train_step`` places them, 32-bit
    mode), and the port's at world 2 and 4 from JAX's initial
    variables."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lidar_object_detection_tpu.models.yolo.model import (
        YoloConfig as JYoloConfig)
    from lidar_object_detection_tpu.parallel import (
        YoloTrainer as JTrainer, make_mesh)
    from lidar_object_detection_tpu.parallel import train as jtrain

    images, targets = det_batch()
    with jax.enable_x64(False):
        mesh = make_mesh(model_parallel=2)
        jt = JTrainer(JYoloConfig(**DET), mesh, image_size=(64, 64))
        init = jax.tree_util.tree_map(np.asarray, jt.state.variables)
        tx = optax.chain(_capture_grads(), jt.tx)
        state = jtrain.TrainState(
            variables=jt.state.variables,
            opt_state=tx.init(jt.state.variables["params"]),
            step=jnp.zeros((), jnp.int32))
        step = jax.jit(functools.partial(
            jtrain._train_step, model=jt.model, tx=tx, num_classes=8,
            level_shapes=jt.level_shapes))
        put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(
            mesh, P("data", *([None] * (np.ndim(a) - 1)))))
        new, m = step(state, put(images),
                      {k: put(v) for k, v in targets.items()})
        ref = {"parts": {k: float(v) for k, v in m.items()},
               "grads": jax.tree_util.tree_map(np.asarray,
                                               new.opt_state[0]),
               "variables": jax.tree_util.tree_map(np.asarray,
                                                   new.variables),
               "adam": jax.tree_util.tree_map(np.asarray,
                                              new.opt_state[1][0])}
    port = {world: spawn("rank_det_step", world, (init, world),
                         tmp_path_factory.mktemp(f"det{world}"))
            for world in (2, 4)}
    return {"init": init, "ref": ref, "port": port}


@pytest.mark.parametrize("world", [2, 4])
def test_step_loss_parts_match_jax_mesh(det_case, world):
    """The whole batch's loss and parts (every rank's shares summed) within
    1e-4 relative of JAX's on its mesh (float32 sums in another order, as
    the one-process step is held)."""
    ref = det_case["ref"]["parts"]
    for res in det_case["port"][world]:
        for key in ("loss", "cls", "box", "dfl"):
            assert rel(res["parts"][key], ref[key]) <= 1e-4, key


@pytest.mark.parametrize("world", [2, 4])
def test_step_gradients_match_jax_mesh(det_case, world):
    """The global batch's gradients (summed over ``data``; the sliced
    kernels gathered) within STEP_TOL of each tensor's largest of JAX's,
    the leaves that are 0 but for rounding within YOLO_ZERO_GRAD_SHARE
    of the largest gradient on both sides."""
    ref = det_case["ref"]["grads"]
    for res in det_case["port"][world]:
        errs = scaled_errors(res["grads"], ref, ZERO_LEAVES)
        worst = max(errs, key=errs.get)
        print(f"world {world}: gradients within {errs[worst]:.3g} of each "
              f"tensor's largest ({worst})")
        assert errs[worst] <= STEP_TOL, (worst, errs[worst])
        assert max(zero_share(res["grads"]), zero_share(ref)) <= \
            chip_smoke.YOLO_ZERO_GRAD_SHARE


@pytest.mark.parametrize("world", [2, 4])
def test_step_state_matches_jax_mesh(det_case, world):
    """After the step: BatchNorm statistics and AdamW's first moment
    within STEP_TOL of each tensor's largest (the second within 2
    STEP_TOL: it squares the gradient); the parameters' update as
    ``check_update`` holds it at JAX's rate 1e-3, fewer than 1e-3 of the
    parameters stepping the other way."""
    ref, init = det_case["ref"], det_case["init"]
    for res in det_case["port"][world]:
        got = res["variables"]
        errs = scaled_errors(got["batch_stats"],
                             ref["variables"]["batch_stats"])
        assert max(errs.values()) <= STEP_TOL
        moved = check_update(got["params"], ref["variables"]["params"],
                             init["params"], res["grads"], ref["grads"],
                             1e-3)
        n = sum(v.size for v in flat(init["params"]).values())
        assert moved < 1e-3 * n
        adam = res["opt"]["0"]
        assert int(adam["count"]) == int(ref["adam"].count) == 1
        for key, tol in (("mu", STEP_TOL), ("nu", 2 * STEP_TOL)):
            errs = scaled_errors(adam[key], getattr(ref["adam"], key),
                                 ZERO_LEAVES)
            assert max(errs.values()) <= tol, key


def test_channel_parallel_step_equals_data_parallel_bit_for_bit(det_case):
    """World 4 (2 x 2: each kernel held in halves over ``model``, gathered
    for the forward) gives world 2's bits: parts, gradients, variables,
    moments and the second step's loss; every rank alike."""
    two, four = det_case["port"][2], det_case["port"][4]
    for res in two + four:
        assert res["parts"] == two[0]["parts"]
        assert res["step2"] == two[0]["step2"]
        for key in ("grads", "variables"):
            a, b = flat(res[key]), flat(two[0][key])
            assert all(np.array_equal(a[k], b[k]) for k in b), key
        for key in ("mu", "nu"):
            a, b = flat(res["opt"]["0"][key]), flat(two[0]["opt"]["0"][key])
            assert all(np.array_equal(a[k], b[k]) for k in b), key
    assert not two[0]["held"]
    sd = from_flax_variables(det_case["init"])
    for res in four:
        assert res["held"]
        for name, shape in res["held"].items():
            full = list(sd[name].shape)
            full[flax_kernel_axes(name)[-1]] //= 2
            assert shape == tuple(full), name


# ---------------------------------------------------------------------------
# param_shardings on the YOLO11n-seg tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_param_shardings_pick_jax_parameters_and_dims(det_case, tp):
    """JAX's ``param_shardings`` on the committed YOLO11n-seg tree over a
    (8 / tp, tp) mesh against the port's rule at tp: the same parameters
    (through the port's weight names), each on the dim that holds the
    Flax kernel's last axis -- dim 0 of a ``Conv2d`` weight, dim 3 (the
    kernel's width) of the Proto's ``ConvTranspose2d``, whose Flax kernel
    keeps torch's (in, out, 2, 2) layout, so that JAX shards it at tp = 2
    and not at tp = 4 -- and each rank's slice holds the values of JAX's
    shard of the same index."""
    import jax
    from jax.sharding import PartitionSpec as P

    from lidar_object_detection_tpu.parallel import make_mesh
    from lidar_object_detection_tpu.parallel.train import param_shardings

    variables = read_flax_msgpack(CKPT)["variables"]
    specs = param_shardings(make_mesh(model_parallel=tp), variables)
    sd = from_flax_variables(variables)
    rule = det_case["port"][4][0]["rules"][tp]
    assert set(rule) == {k for k in sd if "running" not in k}
    sharded = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            specs["params"], is_leaf=lambda x: hasattr(x, "spec"))[0]:
        if sh.spec != P():
            assert sh.spec == P(None, None, None, "model")
            names = tuple(p.key for p in path)
            key = tweights._torch_key(
                *tweights._flax_path_to_torch_key(names), "params")
            sharded[key] = flat(variables["params"])["/".join(names)]
    want = {k: d for k, d in rule.items() if d is not None}
    assert sharded and set(want) == set(sharded)
    upsample = "model.23.proto.upsample.weight"
    assert (upsample in want) == (tp == 2)
    for key, dim in want.items():
        assert dim == flax_kernel_axes(key)[-1], key
        # each rank's slice holds the values of JAX's shard of its index
        w = sd[key]
        k = w.shape[dim] // tp
        for c in range(tp):
            mine = np.transpose(w.narrow(dim, c * k, k).numpy(),
                                flax_kernel_axes(key))
            np.testing.assert_array_equal(
                mine, np.split(sharded[key], tp, axis=-1)[c])


# ---------------------------------------------------------------------------
# segment on: the port at world 2 against its one-process step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_case(tmp_path_factory):
    from lidar_object_detection_tpu_torch.parallel.train import YoloTrainer

    torch.manual_seed(0)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = YoloTrainer(YoloConfig(scale="n"), image_size=(64, 128),
                         max_targets=6, device="cpu")
        tr.load(read_flax_msgpack(CKPT)["variables"])
        images, targets = seg_batch()
        imgs, tg = tr.put(images, targets)
        loss, parts = tr.loss(imgs, tg)
        grads = tr.gradients(loss)
        one = ({"loss": float(loss.detach()),
                **{k: float(v.detach()) for k, v in parts.items()}},
               yolo_flax_from_state(grads)["params"])
    finally:
        torch.set_num_threads(saved)
    return {"one": one,
            **{name: spawn("rank_seg_step", 2, (ddp,),
                           tmp_path_factory.mktemp(name))
               for name, ddp in (("synced", False), ("ddp", True))}}


def test_segment_step_at_world_two_equals_one_process(seg_case):
    """Synced BatchNorm statistics and the whole batch's TAL and mask-loss
    normalisers: the loss parts (cls, box, dfl, seg) within
    SYNC_PARTS_RTOL relative and every gradient within SYNC_TOL of its
    tensor's largest of the one-process step (the statistics' and
    normalisers' sums split in two: 4.4e-6 and 4.5e-5 measured)."""
    one_parts, one_grads = seg_case["one"]
    for parts, grads in seg_case["synced"]:
        for key in ("loss", "cls", "box", "dfl", "seg"):
            assert rel(parts[key], one_parts[key]) <= SYNC_PARTS_RTOL, key
        errs = scaled_errors(grads, one_grads, ZERO_LEAVES)
        print(f"synced: gradients within {max(errs.values()):.3g}, parts "
              f"within {max(rel(parts[k], one_parts[k]) for k in parts):.3g}")
        assert max(errs.values()) <= SYNC_TOL, max(errs, key=errs.get)


def test_ddp_style_local_normalisation_fails_the_same_check(seg_case):
    """DistributedDataParallel's step on the same ranks (local BatchNorm
    statistics over 2 frames, local normalisers, the mean of the
    gradients) is another step: its gradients miss SYNC_TOL by more than
    a hundred times (16.8 of a tensor's largest measured), and its loss
    parts miss SYNC_PARTS_RTOL (0.52 relative)."""
    one_parts, one_grads = seg_case["one"]
    for parts, grads in seg_case["ddp"]:
        errs = scaled_errors(grads, one_grads, ZERO_LEAVES)
        print(f"DDP-style: gradients off by {max(errs.values()):.3g}, parts "
              f"by {max(rel(parts[k], one_parts[k]) for k in parts):.3g}")
        assert max(errs.values()) > 100 * SYNC_TOL
        assert max(rel(parts[k], one_parts[k])
                   for k in ("cls", "box", "dfl", "seg")) > SYNC_PARTS_RTOL


def test_world_of_one_mesh_trainer_is_the_one_card_trainer(tmp_path):
    """A 1 x 1 mesh (the group brought up by ``make_mesh``) gives the
    one-card trainer's bytes after two steps with the EMA on: metrics,
    variables, EMA and AdamW state."""
    (m0, v0, e0, o0), (m1, v1, e1, o1) = spawn("rank_world_of_one", 1, (),
                                               tmp_path)[0]
    assert m0 == m1
    for a, b in ((v0, v1), (e0, e1), (o0["0"]["mu"], o1["0"]["mu"]),
                 (o0["0"]["nu"], o1["0"]["nu"])):
        fa, fb = flat(a), flat(b)
        assert fa.keys() == fb.keys()
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)
