"""The port's PointPillars inference pipeline against the JAX package's,
on a synthetic KITTI-360 tree (``chip_smoke.write_kitti360_tree``, with
pose files) built in ``tmp_path``: sweep aggregation, the GT-aware cap,
the BEV evaluation, ``infer_pointpillars`` and the ``pointpillars-infer``
subcommand with their ``detections_*.json`` and ``scene_*.ply`` files,
and the checkpoint sidecar's check.

The committed surround checkpoints run on a +-10.24 m grid (64 x 64): the
test copies a checkpoint into ``tmp_path`` beside a sidecar that names that
grid, and for the CLI, which has only the surround preset, both packages'
``PillarsConfig.kitti360_surround`` return it.

Tolerances: aggregated clouds, capped clouds and evaluation counts exact
(the same float64 host code); GT boxes7 within 2e-5 (a float32 corner
transform in another library); detections' frames, classes and counts
exact, boxes7 within 1e-4 and scores within 1e-5 (the network's heads
differ by up to about 2e-5, `test_torch_pointpillars.py`); PLY headers,
colours and edges exact, coordinates within 1e-4 (printed with 6
decimals).
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.data import poses as jposes
from lidar_object_detection_tpu.data.kitti360 import (
    Kitti360Dataset as JaxDataset)
from lidar_object_detection_tpu.models.pointpillars import (
    PillarGridConfig as JaxGrid, PillarsConfig as JaxConfig)
from lidar_object_detection_tpu.pipelines import cli as jcli
from lidar_object_detection_tpu.pipelines import pointpillars as jpipe
from lidar_object_detection_tpu_torch.data import poses as tposes
from lidar_object_detection_tpu_torch.data.kitti360 import Kitti360Dataset
from lidar_object_detection_tpu_torch.models.pointpillars import (
    PillarGridConfig, PillarsConfig, boxes7_to_corners)
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.pipelines import cli
from lidar_object_detection_tpu_torch.pipelines import pointpillars as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {head: os.path.join(REPO, "checkpoints",
                            f"pp_{head}_surround.msgpack")
         for head in ("ssd", "center")}
SMALL_GRID = dict(x_range=(-10.24, 10.24), y_range=(-10.24, 10.24),
                  z_range=(-5.0, 1.5), pillar_size=0.32)
# low enough that the synthetic cars give detections to compare
THRESHOLDS = {"ssd": 0.004, "center": 0.02}
FRAMES = (100, 101, 103)
# the frames inference runs on (over the aggregate of all three sweeps)
TARGETS = (100, 103)
MAX_POINTS = 6144


def small_configs(head):
    return (JaxConfig(grid=JaxGrid(**SMALL_GRID), head=head),
            PillarsConfig(grid=PillarGridConfig(**SMALL_GRID), head=head))


def scene(rng, k):
    """Frame k's velodyne points (car-shaped clusters, a ground plane,
    clutter out to 14 m) and its cars' boxes7, 10 % larger than the
    clusters so that no point lies on a box face."""
    cars = np.array([[3.0, 2.0, -1.0, 1.7, 4.2, 1.5, 0.3],
                     [3.4, 2.3, -1.0, 1.7, 4.2, 1.5, 0.4],
                     [-5.0, -4.0, -1.0, 1.8, 4.5, 1.6, 1.6],
                     [6.0, -6.0, -0.9, 1.6, 3.9, 1.5, -0.8]], np.float32)
    cars[:, :2] += np.float32(0.4 * k)
    chunks = []
    for x, y, z, w, l, h, yaw in cars:
        u = rng.uniform(-0.45, 0.45, (700, 3))
        c, s = np.cos(yaw), np.sin(yaw)
        chunks.append(np.stack([x + u[:, 0] * l * c - u[:, 1] * w * s,
                                y + u[:, 0] * l * s + u[:, 1] * w * c,
                                z + u[:, 2] * h], 1))
    ground = rng.uniform(-14, 14, (2500, 2))
    chunks.append(np.concatenate([ground, np.full((2500, 1), -1.75)], 1))
    chunks.append(rng.uniform([-14, -14, -3], [14, 14, 2], (500, 3)))
    xyz = np.concatenate(chunks).astype(np.float32)
    pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1))], 1)
    boxes = cars.copy()
    boxes[:, 3:6] *= np.float32(1.1)
    return pts.astype(np.float32), boxes


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 frames of synthetic scans with boxes and pose files."""
    rng = np.random.default_rng(7)
    root = str(tmp_path_factory.mktemp("pp_tree"))
    frames = []
    for k, fid in enumerate(FRAMES):
        pts, boxes = scene(rng, k)
        corners_velo = boxes7_to_corners(torch.from_numpy(boxes)).numpy()
        corners_cam = (corners_velo @ chip_smoke.VELO_TO_RECT[:3, :3].T
                       + chip_smoke.VELO_TO_RECT[:3, 3])
        frames.append((fid, None, pts, corners_cam.astype(np.float32)))
    chip_smoke.write_kitti360_tree(root, frames)
    return root


@pytest.fixture()
def ckpt(tmp_path):
    """Each committed checkpoint beside a sidecar naming the small grid."""
    out = {}
    for head, path in CKPTS.items():
        dst = str(tmp_path / os.path.basename(path))
        os.symlink(path, dst)
        with open(dst + ".json", "w") as f:
            json.dump(tpipe.pillars_config_meta(small_configs(head)[1]), f)
        out[head] = dst
    return out


def test_pose_table_and_aggregation_match_jax(tree):
    jds, tds = JaxDataset(tree), Kitti360Dataset(tree)
    for kind in ("cam0_to_world", "poses"):
        jt = jposes.load_pose_table(tree, kind=kind)
        tt = tposes.load_pose_table(tree, kind=kind)
        np.testing.assert_array_equal(tt.frames, jt.frames)
        np.testing.assert_array_equal(tt.transforms, jt.transforms)
        # nearest lookup of a frame between two rows, exact rows refused
        np.testing.assert_array_equal(tt.lookup(102), jt.lookup(102))
        with pytest.raises(KeyError):
            tt.lookup(102, nearest=False)
    for target in (100, 103):
        got = tposes.aggregate_sweeps(tds, target, list(FRAMES))
        ref = jposes.aggregate_sweeps(jds, target, list(FRAMES))
        np.testing.assert_array_equal(got.points, ref.points)
        np.testing.assert_array_equal(got.point_valid, ref.point_valid)
        np.testing.assert_array_equal(got.sweep_id, ref.sweep_id)
        assert got.num_valid == ref.num_valid > 3 * 5000
    capped = tposes.aggregate_sweeps(tds, 101, list(FRAMES), max_points=8192)
    ref = jposes.aggregate_sweeps(jds, 101, list(FRAMES), max_points=8192)
    np.testing.assert_array_equal(capped.points, ref.points)


def test_aggregated_frames_and_point_cap_match_jax(tree):
    jcfg, tcfg = small_configs("ssd")
    kw = dict(grid=None, max_points=MAX_POINTS, protect_in_box=300)
    got = tpipe.load_aggregated_frames(Kitti360Dataset(tree), FRAMES,
                                       **dict(kw, grid=tcfg.grid))
    ref = jpipe.load_aggregated_frames(JaxDataset(tree), FRAMES,
                                       **dict(kw, grid=jcfg.grid))
    for (pts, boxes), (rpts, rboxes) in zip(got, ref, strict=True):
        np.testing.assert_allclose(boxes, rboxes, rtol=0, atol=2e-5)
        np.testing.assert_array_equal(pts, rpts)
        assert len(pts) == MAX_POINTS and boxes.shape == (4, 7)
    pts, boxes = got[0]
    for protect in (0, 50, 5000):
        np.testing.assert_array_equal(
            tpipe.cap_points_protected(pts, boxes, 2000, protect),
            jpipe.cap_points_protected(pts, boxes, 2000, protect))


def test_evaluation_matches_jax(rng):
    gts = [rng.uniform([-20, -20, -2, 1.5, 3.5, 1.4, -3],
                       [20, 20, 0, 2.0, 4.8, 1.7, 3], (g, 7)).astype(
        np.float32) for g in (6, 0, 9)]
    dets, det_dicts = [], []
    for g in gts:
        boxes = np.concatenate([
            g + rng.normal(0, 0.3, g.shape).astype(np.float32),
            rng.uniform(-20, 20, (4, 7)).astype(np.float32)])
        boxes[:, 3:6] = np.abs(boxes[:, 3:6]) + 1
        scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
        valid = scores > 0.2
        dets.append((boxes[valid], scores[valid]))
        det_dicts.append({"boxes7": boxes, "valid": valid})
    for exact in (False, True):
        for d, g in zip(det_dicts, gts):
            gv = np.ones(len(g), bool)
            got = tpipe.evaluate_bev(d, g, gv, 0.3, exact=exact)
            ref = jpipe.evaluate_bev(d, g, gv, 0.3, exact=exact)
            assert (got.matched, got.total_gt, got.total_det) == \
                (ref.matched, ref.total_gt, ref.total_det)
            np.testing.assert_array_equal(got.matched_gt, ref.matched_gt)
    assert tpipe.bev_average_precision(dets, gts, 0.3) == \
        jpipe.bev_average_precision(dets, gts, 0.3) > 0


def assert_same_outputs(got_dir, ref_dir, frames, ply=True):
    """detections_*.json and scene_*.ply of two runs, within the module's
    tolerances; returns the number of detections."""
    total = 0
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(got_dir)) == names
    assert len(names) == len(frames) * (2 if ply else 1)
    for frame in frames:
        with open(os.path.join(got_dir, f"detections_{frame:010d}.json")) \
                as f:
            got = json.load(f)
        with open(os.path.join(ref_dir, f"detections_{frame:010d}.json")) \
                as f:
            ref = json.load(f)
        assert sorted(got) == sorted(ref)
        for key in ("frame", "classes", "ckpt_step"):
            assert got[key] == ref[key]
        np.testing.assert_allclose(np.asarray(got["boxes7"]).reshape(-1, 7),
                                   np.asarray(ref["boxes7"]).reshape(-1, 7),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0,
                                   atol=1e-5)
        total += len(ref["scores"])
        if ply:
            assert_same_ply(os.path.join(got_dir, f"scene_{frame:010d}.ply"),
                            os.path.join(ref_dir, f"scene_{frame:010d}.ply"))
    return total


def assert_same_ply(got_path, ref_path):
    with open(got_path) as f:
        got = f.read().splitlines()
    with open(ref_path) as f:
        ref = f.read().splitlines()
    assert len(got) == len(ref)
    end = ref.index("end_header")
    assert got[:end + 1] == ref[:end + 1]
    n = int(ref[2].split()[-1])
    vg = np.array([line.split() for line in got[end + 1:end + 1 + n]],
                  float)
    vr = np.array([line.split() for line in ref[end + 1:end + 1 + n]],
                  float)
    np.testing.assert_allclose(vg[:, :3], vr[:, :3], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(vg[:, 3:], vr[:, 3:])
    assert got[end + 1 + n:] == ref[end + 1 + n:]


@pytest.mark.parametrize("head,rotated", [("ssd", True), ("ssd", False),
                                          ("center", True)])
def test_infer_pointpillars_matches_jax(tree, ckpt, tmp_path, head,
                                        rotated):
    jcfg, tcfg = small_configs(head)
    kw = dict(frame_ids=list(TARGETS[1:]), aggregate=True,
              max_points=MAX_POINTS,
              score_threshold=THRESHOLDS[head], rotated_nms=rotated,
              export_ply=True)
    before = dict(kernel_lib.LAUNCHES)
    got = tpipe.infer_pointpillars(tree, ckpt[head], cfg=tcfg,
                                   output_dir=str(tmp_path / "port"),
                                   device="cpu", **kw)
    assert kernel_lib.LAUNCHES == before
    ref = jpipe.infer_pointpillars(tree, ckpt[head], cfg=jcfg,
                                   output_dir=str(tmp_path / "jax"), **kw)
    for g, r in zip(got, ref, strict=True):
        assert sorted(g) == sorted(r)
        assert (g["frame"], g["ckpt_step"]) == (r["frame"], r["ckpt_step"])
        np.testing.assert_array_equal(g["classes"], r["classes"])
        np.testing.assert_allclose(g["boxes7"], r["boxes7"], rtol=0,
                                   atol=1e-4)
    n = assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"),
                            TARGETS[1:])
    assert n >= 1


def test_cli_pointpillars_infer_matches_jax(tree, ckpt, tmp_path,
                                            monkeypatch, capsys):
    """``pointpillars-infer --surround --aggregate-sweeps --export-ply`` of
    both packages, the surround preset cut to the small grid."""
    for config in (JaxConfig, PillarsConfig):
        grid = type(config().grid)(**SMALL_GRID)
        monkeypatch.setattr(config, "kitti360_surround",
                            staticmethod(lambda c=config, g=grid: c(grid=g)))
    argv = ["pointpillars-infer", "--dataset", tree, "--ckpt", ckpt["ssd"],
            "--frames", *map(str, TARGETS),
            "--surround", "--aggregate-sweeps", "--head", "ssd",
            "--score-threshold", str(THRESHOLDS["ssd"]), "--max-points",
            str(MAX_POINTS), "--export-ply", "--output"]
    assert cli.main(argv + [str(tmp_path / "port"), "--device", "cpu"]) == 0
    port_text = capsys.readouterr().out
    assert jcli.main(argv + [str(tmp_path / "jax")]) == 0
    jax_text = capsys.readouterr().out
    assert port_text.splitlines()[-1].replace(str(tmp_path / "port"), "") \
        == jax_text.splitlines()[-1].replace(str(tmp_path / "jax"), "")
    assert assert_same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"),
                               TARGETS) >= len(TARGETS)


def test_checkpoint_sidecar_is_checked_as_in_jax(tmp_path):
    """The committed sidecar names the surround grid: a small-grid config
    is refused by both packages; a checkpoint without a sidecar warns."""
    for head, path in CKPTS.items():
        jcfg, tcfg = small_configs(head)
        with pytest.raises(ValueError, match="different config"):
            tpipe.load_pillars_variables(path, expect_cfg=tcfg)
        with pytest.raises(ValueError, match="different config"):
            jpipe.load_pillars_variables(path, expect_cfg=jcfg)
        surround = dataclasses.replace(PillarsConfig.kitti360_surround(),
                                       head=head)
        _, step = tpipe.load_pillars_variables(path, expect_cfg=surround)
        other = dataclasses.replace(surround,
                                    head="center" if head == "ssd" else "ssd")
        with pytest.raises(ValueError, match="head"):
            tpipe.load_pillars_variables(path, expect_cfg=other)
        assert step == {"ssd": 15000, "center": 16000}[head]
    bare = str(tmp_path / "bare.msgpack")
    os.symlink(CKPTS["ssd"], bare)
    with pytest.warns(UserWarning, match="sidecar"):
        tpipe.load_pillars_variables(bare, expect_cfg=small_configs("ssd")[1])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tpipe.load_pillars_variables(bare)
