"""The port's scale-out layer (``parallel/{distributed,mesh,sharding,
pipeline,dryrun}.py``, ``parallel/collectives.py``) on CPU ranks over
gloo, against the JAX package's sharded fusion and the sequential chain.

Each multi-rank check spawns 2 or 4 ranks in fresh processes
(``distributed.spawn``: a file store under ``tmp_path``, one PyTorch
thread a rank, a hard timeout) once per module, and the tests read what
the ranks returned.  The ranks import no JAX: this module imports it
inside the fixtures that compute the references, so that a rank can
import the module's rank functions.  The JAX references run on the
8-device virtual CPU mesh of ``tests/conftest.py``.

Sizes: the 2048-point frame of ``tests/test_distributed.py`` (96 x 512,
32 detections, 8 boxes), as V2 stats and as csv_eval with erosion, and a
batch of 4 such frames; the pipeline of ``tests/test_pipeline_parallel
.py``'s stage (D = 16, micro-batches of 4) at S = 2 and 4 stages, M = 1
and 3 micro-batches.

Tolerances: fusion counts, totals, best boxes, inside counts and matches
bit for bit (exact integers); the pipeline's outputs and gradients equal
the port's sequential chain run micro-batch by micro-batch bit for bit
(the same operations on the same rows), and within 1e-5 (outputs and
loss, relative) and 1e-5 of each gradient's largest entry of JAX's
sequential chain (float32 products summed in another order, as
``tests/test_pipeline_parallel.py`` holds JAX's own pipeline).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from lidar_object_detection_tpu_torch.config import (
    FusionConfig, FusionParams, PipelineVersion, ShapeConfig)
from lidar_object_detection_tpu_torch.parallel import distributed

HERE = os.path.dirname(os.path.abspath(__file__))
SMALL = ShapeConfig(max_points=2048, max_detections=32, max_boxes=8,
                    image_height=96, image_width=512)
VERSIONS = ("v2_stats", "csv_eval")
FUSION_KEYS = ("counts", "total_points", "best_box", "points_inside",
               "matched")
D, MB = 16, 4
PIPELINES = [(2, 1), (2, 3), (4, 1), (4, 3)]     # (stages, micro-batches)
TIMEOUT = 240


def params_of(version):
    cfg = FusionConfig.for_version(PipelineVersion(version))
    return FusionParams.from_config(dataclasses.replace(cfg, shapes=SMALL))


def fusion_frame(seed=7):
    """The frame of ``tests/test_distributed.py``: a cluster of 128 points
    inside box 0 that projects into detection 0's mask block."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(2048, 4)) * 10).astype(np.float32)
    pts[:128, 0] = rng.uniform(0.2, 1.8, 128)
    pts[:128, 1] = rng.uniform(0.05, 0.45, 128)
    pts[:128, 2] = rng.uniform(8.1, 9.4, 128)
    pvalid = np.ones(2048, bool)
    pvalid[-5:] = False
    mask_bits = np.zeros((96, 512), np.int32)
    mask_bits[20:60, 100:400] = 1
    mask_bits[30:50, 150:250] |= 2
    det_valid = np.zeros(32, bool)
    det_valid[:2] = True
    corners = np.zeros((8, 8, 3), np.float32)
    corners[0] = [[0, 0, 8], [2, 0, 8], [2, 4, 8], [0, 4, 8],
                  [0, 0, 9.5], [2, 0, 9.5], [2, 4, 9.5], [0, 4, 9.5]]
    corners[1] = corners[0] + np.float32([0.5, 0.0, 0.3])
    box_valid = np.zeros(8, bool)
    box_valid[:2] = True
    return (pts, pvalid, mask_bits, det_valid, corners, box_valid)


def calib():
    eye = np.eye(4, dtype=np.float32)
    intr = np.asarray([[200.0, 0, 256], [0, 200, 48], [0, 0, 1]],
                      np.float32)
    return eye, eye, intr


def fusion_batch():
    """4 frames: the frame of seed 7 and three others."""
    frames = [fusion_frame(seed) for seed in (7, 8, 9, 10)]
    return tuple(np.stack([f[i] for f in frames]) for i in range(6))


def pipeline_case(s, m, seed=0):
    rng = np.random.default_rng(seed + 10 * s + m)
    w = rng.normal(0, 0.5, (s, D, D)).astype(np.float32)
    b = rng.normal(0, 0.1, (s, D)).astype(np.float32)
    x = rng.normal(size=(m, MB, D)).astype(np.float32)
    y = rng.normal(size=(m, MB, D)).astype(np.float32)
    return w, b, x, y


def stage(params, h):
    return torch.relu(h @ params["w"] + params["b"])


def mse(out, tgt):
    return torch.mean((out - tgt) ** 2)


def port_sequential(w, b, x, y):
    """The port's sequential chain, micro-batch by micro-batch: outputs,
    loss and the gradients of (w, b)."""
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    outs = []
    for mb in torch.from_numpy(x):
        h = mb
        for i in range(w.shape[0]):
            h = stage({"w": wt[i], "b": bt[i]}, h)
        outs.append(h)
    out = torch.stack(outs)
    loss = mse(out, torch.from_numpy(y))
    gw, gb = torch.autograd.grad(loss, [wt, bt])
    return (out.detach().numpy(), float(loss.detach()), gw.numpy(),
            gb.numpy())


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def rank_checks(world):
    """Every multi-rank check of this module on one rank; returns numpy
    results."""
    import torch.distributed as dist

    from lidar_object_detection_tpu_torch.parallel import (
        make_mesh, pipeline_apply, pipeline_loss_fn,
        point_sharded_fuse_frame, sharded_fuse_batch)
    from lidar_object_detection_tpu_torch.parallel.mesh import (
        data_sharding, point_sharding)

    t = torch.from_numpy
    res = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "primary": distributed.is_primary()}
    meshes = {mp: make_mesh("cpu", mp) for mp in sorted({1, 2, world})}
    res["mesh"] = {mp: (tuple(m.shape), m.mesh_dim_names,
                        m.get_local_rank("data"), m.get_local_rank("model"))
                   for mp, m in meshes.items()}
    try:
        make_mesh("cpu", 3)
    except ValueError as e:
        res["mesh_error"] = str(e)

    cal = tuple(t(a) for a in calib())
    frame = tuple(t(a) for a in fusion_frame())
    res["point_sharded"] = {
        version: {k: v.numpy() for k, v in point_sharded_fuse_frame(
            meshes[world], *frame, *cal, params_of(version)).items()}
        for version in VERSIONS}
    batch = tuple(t(a) for a in fusion_batch())
    res["frame_sharded"] = {
        mp: {k: v.numpy() for k, v in sharded_fuse_batch(
            meshes[mp], batch, cal, params_of("csv_eval")).items()}
        for mp in meshes if world // mp > 1}
    errors = []
    for fn in (lambda: point_sharded_fuse_frame(
            meshes[world], frame[0][:-1], frame[1][:-1], *frame[2:], *cal,
            params_of("v2_stats")),
            lambda: data_sharding(meshes[1], batch[0][:3]),
            lambda: point_sharding(meshes[world], batch[0][:, :-1])):
        try:
            fn()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    res["refusals"] = errors

    res["pipeline"] = {}
    for s, m in PIPELINES:
        if world % s:
            continue
        w, b, x, y = pipeline_case(s, m)
        params = {"w": t(w).requires_grad_(True),
                  "b": t(b).requires_grad_(True)}
        loss_fn = pipeline_loss_fn(meshes[s], stage, mse)
        loss = loss_fn(params, t(x), t(y))
        gw, gb = torch.autograd.grad(loss, [params["w"], params["b"]])
        with torch.no_grad():
            out = pipeline_apply(meshes[s], stage, params, t(x))
        res["pipeline"][(s, m)] = (out.numpy(), float(loss.detach()),
                                   gw.numpy(),
                                   gb.numpy())
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's ranks' results: {2: [rank 0, rank 1], 4: [...]}."""
    out = {}
    for world in (2, 4):
        runs = distributed.spawn(
            "test_torch_scale_out:rank_checks", world, (world,),
            timeout=TIMEOUT, device="cpu", path=[HERE],
            workdir=str(tmp_path_factory.mktemp(f"world{world}")))
        out[world] = [r.value for r in runs]
    return out


@pytest.fixture(scope="module")
def jax_fusion():
    """JAX's ``point_sharded_fuse_frame`` over 2 and 4 devices' model axis
    (under ``jax.jit``: eagerly its ``shard_map`` takes 15 s a call here)
    and its ``sharded_fuse_batch`` over a (4, 2) mesh, on the same
    frames."""
    import functools

    import jax
    import jax.numpy as jnp

    from lidar_object_detection_tpu.config import (
        FusionConfig as JFusionConfig, PipelineVersion as JVersion,
        ShapeConfig as JShapeConfig)
    from lidar_object_detection_tpu.fusion import FusionParams as JParams
    from lidar_object_detection_tpu.parallel import (
        make_mesh, point_sharded_fuse_frame, sharded_fuse_batch)

    small = JShapeConfig(max_points=2048, max_detections=32, max_boxes=8,
                         image_height=96, image_width=512)

    def jparams(version):
        return JParams.from_config(dataclasses.replace(
            JFusionConfig.for_version(JVersion(version)), shapes=small))

    frame = fusion_frame()
    jframe = [jnp.asarray(a) for a in frame]
    jframe[2] = jnp.asarray(frame[2].astype(np.uint32))
    cal = calib()
    ref = {"point_sharded": {}}
    with jax.enable_x64(False):
        for n in (2, 4):
            mesh = make_mesh(jax.devices()[:n], model_parallel=n)
            ref["point_sharded"][n] = {
                version: {k: np.asarray(v) for k, v in jax.jit(
                    functools.partial(point_sharded_fuse_frame, mesh,
                                      params=jparams(version)))(
                    *jframe, *cal).items()} for version in VERSIONS}
        batch = list(fusion_batch())
        batch[2] = batch[2].astype(np.uint32)
        out = sharded_fuse_batch(make_mesh(model_parallel=2), batch, cal,
                                 jparams("csv_eval"))
        ref["frame_sharded"] = {k: np.asarray(out[k]) for k in FUSION_KEYS}
    return ref


# ---------------------------------------------------------------------------
# mesh and distributed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_mesh_shapes_axis_names_and_coordinates(ranks, world):
    """make_mesh(mp) is (world / mp, mp) with dims ("data", "model"), rank
    r at (r // mp, r % mp)."""
    for rank, res in enumerate(ranks[world]):
        assert res["rank"] == rank and res["world"] == world
        for mp, (shape, names, di, mi) in res["mesh"].items():
            assert shape == (world // mp, mp)
            assert names == ("data", "model")
            assert (di, mi) == (rank // mp, rank % mp)


def test_mesh_refuses_a_model_axis_that_does_not_divide(ranks):
    """JAX's message: "4 devices not divisible by model_parallel=3"."""
    for res in ranks[4]:
        assert res["mesh_error"] == ("4 devices not divisible by "
                                     "model_parallel=3")


def test_world_of_one_without_a_group():
    """With no process group up, make_mesh brings up a world of one (a 1 x
    1 mesh, JAX's single-chip mesh); the sharded fusion then equals
    fuse_frame."""
    import torch.distributed as dist

    from lidar_object_detection_tpu_torch.fusion.associate import fuse_frame
    from lidar_object_detection_tpu_torch.parallel import (
        make_mesh, point_sharded_fuse_frame)

    assert not dist.is_initialized()
    try:
        mesh = make_mesh("cpu")
        assert dist.get_world_size() == 1 and tuple(mesh.shape) == (1, 1)
        assert distributed.is_primary()
        frame = [torch.from_numpy(a) for a in fusion_frame()]
        cal = [torch.from_numpy(a) for a in calib()]
        got = point_sharded_fuse_frame(mesh, *frame, *cal,
                                       params_of("csv_eval"))
        ref = fuse_frame(*frame, *cal, params_of("csv_eval"))
        for key in FUSION_KEYS:
            assert torch.equal(got[key], ref[key]), key
    finally:
        dist.destroy_process_group()


def test_initialize_twice_is_a_no_op_and_is_primary():
    """initialize() brings the group up once (True), a second call does
    nothing (False), as jax.distributed's; is_primary() is rank 0, and
    true with no group."""
    import torch.distributed as dist

    assert distributed.is_primary()
    try:
        assert distributed.initialize(device="cpu") is True
        assert distributed.initialize(device="cpu") is False
        assert dist.get_world_size() == 1 and distributed.is_primary()
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized() and distributed.is_primary()


@pytest.mark.parametrize("world", [2, 4])
def test_is_primary_on_rank_zero_only(ranks, world):
    assert [res["primary"] for res in ranks[world]] == \
        [True] + [False] * (world - 1)


@pytest.mark.parametrize("device,local,cards,want", [
    ("cpu", 1, 0, "gloo"), ("cpu", 2, 4, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo")])
def test_default_backend_is_nccl_unless_ranks_share_a_card(
        monkeypatch, device, local, cards, want):
    """NCCL on the card while each local rank has a card of its own; gloo
    where the ranks outnumber the cards (NCCL refuses two ranks on one
    card) and on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed.default_backend(device, local) == want


def test_scale_out_entry_points_default_to_the_card():
    """The dry run, its command line, spawn and initialize run on the card
    unless the caller passes the CPU."""
    import inspect

    from lidar_object_detection_tpu_torch.parallel import dryrun

    for fn in (dryrun.dryrun_multichip, distributed.spawn,
               distributed.initialize):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    seen = {}
    real = dryrun.dryrun_multichip
    try:
        dryrun.dryrun_multichip = lambda n, **kw: seen.update(n=n, **kw)
        assert dryrun.main(["2"]) == 0
    finally:
        dryrun.dryrun_multichip = real
    assert seen["n"] == 2 and seen["device"] == "cuda"


def test_initialize_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.initialize(device="cuda")


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("version", VERSIONS)
def test_point_sharded_fusion_equals_jax_and_fuse_frame(ranks, jax_fusion,
                                                        world, version):
    """Points over ``model`` (2 and 4 ranks): counts, totals, best box,
    inside counts and matches bit for bit equal to JAX's
    point_sharded_fuse_frame on as many devices and to the port's
    unsharded fuse_frame, on every rank; the frame counts points."""
    from lidar_object_detection_tpu_torch.fusion.associate import fuse_frame

    frame = [torch.from_numpy(a) for a in fusion_frame()]
    cal = [torch.from_numpy(a) for a in calib()]
    port = fuse_frame(*frame, *cal, params_of(version))
    ref = jax_fusion["point_sharded"][world][version]
    assert int(ref["counts"].sum()) > 0 and bool(ref["matched"].any())
    for res in ranks[world]:
        got = res["point_sharded"][version]
        for key in FUSION_KEYS:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
            np.testing.assert_array_equal(got[key], port[key].numpy(),
                                          err_msg=key)


@pytest.mark.parametrize("world,mp", [(2, 1), (4, 1), (4, 2)])
def test_frame_sharded_fusion_equals_jax(ranks, jax_fusion, world, mp):
    """sharded_fuse_batch (frames over ``data``, csv_eval): the whole
    batch's outputs on every rank, bit for bit JAX's sharded_fuse_batch
    and the port's unsharded fuse_batch."""
    from lidar_object_detection_tpu_torch.fusion.associate import fuse_batch

    batch = [torch.from_numpy(a) for a in fusion_batch()]
    cal = [torch.from_numpy(a) for a in calib()]
    port = fuse_batch(*batch, *cal, params=params_of("csv_eval"))
    ref = jax_fusion["frame_sharded"]
    for res in ranks[world]:
        got = res["frame_sharded"][mp]
        assert got.keys() == port.keys()
        for key in FUSION_KEYS:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        for key in port:
            np.testing.assert_array_equal(got[key], port[key].numpy(),
                                          err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_placements_refuse_what_does_not_divide(ranks, world):
    """A point count that the model axis does not divide, 3 frames over 2
    data rows, a point axis of 2047 over the model axis: each raises."""
    for res in ranks[world]:
        point, frames, points = res["refusals"]
        assert point == "point count must divide the model axis"
        assert "frame axis of size 3" in frames
        assert "point axis of size 2047" in points


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sequential():
    """JAX's sequential chain (``tests/test_pipeline_parallel.py``'s stage)
    and its gradients, per (S, M)."""
    import jax
    import jax.numpy as jnp

    def seq(params, x):
        h = x
        for i in range(params["w"].shape[0]):
            h = jax.nn.relu(h @ params["w"][i] + params["b"][i])
        return h

    out = {}
    with jax.enable_x64(False):
        for s, m in PIPELINES:
            w, b, x, y = pipeline_case(s, m)
            params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}

            def loss(p, x_=jnp.asarray(x), y_=jnp.asarray(y)):
                o = seq(p, x_.reshape(-1, D)).reshape(x_.shape)
                return jnp.mean((o - y_) ** 2)

            val, grads = jax.value_and_grad(loss)(params)
            o = seq(params, jnp.asarray(x).reshape(-1, D)).reshape(x.shape)
            out[(s, m)] = (np.asarray(o), float(val), np.asarray(grads["w"]),
                           np.asarray(grads["b"]))
    return out


@pytest.mark.parametrize("world,s,m", [(w, s, m) for w in (2, 4)
                                        for s, m in PIPELINES if w % s == 0])
def test_pipeline_matches_the_sequential_chain(ranks, jax_sequential, world,
                                               s, m):
    """S stages over ``model`` (at world 4 also two pipelines of 2 stages,
    one per ``data`` row), M micro-batches: every rank's outputs, loss and
    stage gradients equal the port's sequential chain bit for bit and
    JAX's within 1e-5."""
    seq = port_sequential(*pipeline_case(s, m))
    ref = jax_sequential[(s, m)]
    for res in ranks[world]:
        out, loss, gw, gb = res["pipeline"][(s, m)]
        np.testing.assert_array_equal(out, seq[0])
        assert loss == seq[1]
        np.testing.assert_array_equal(gw, seq[2])
        np.testing.assert_array_equal(gb, seq[3])
        np.testing.assert_allclose(out, ref[0], rtol=1e-5, atol=1e-5)
        assert abs(loss - ref[1]) <= 1e-5 * abs(ref[1])
        for got, want in ((gw, ref[2]), (gb, ref[3])):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_multichip_four_ranks(capsys):
    """dryrun_multichip(4) on the CPU (a 2 x 2 mesh) marks every step,
    the pipeline's too, inside its timeout."""
    from lidar_object_detection_tpu_torch.parallel.dryrun import (
        dryrun_multichip)

    dryrun_multichip(4, device="cpu", timeout=TIMEOUT)
    out = capsys.readouterr().out
    for step in ("mesh ready", "yolo dp x tp train step done",
                 "point-sharded fusion done",
                 "point-sharded fusion (erosion) done",
                 "pointpillars dp train step done",
                 "pipeline-parallel step done",
                 "dryrun_multichip(4) OK"):
        assert step in out, out
