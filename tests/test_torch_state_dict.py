"""Torch state-dict weights in the port, against the JAX package, on the
CPU.

* An ultralytics-keyed state dict, made from the committed n checkpoint's
  Flax tree with the JAX package's own key mapping (plus the DFL
  projection and ``num_batches_tracked`` entries a real one carries):
  the JAX and the port ``convert_state_dict`` give equal arrays at every
  path, for the segment and the detection-only networks, and the port's
  template has the Flax ``init``'s paths and shapes.
* ``torch.save`` round trip through both loaders; a file that pickles a
  class raises.
* The msgpack writer: ``flax.serialization.msgpack_restore`` and the
  port's reader read it back, and it encodes the committed checkpoint's
  tree into the committed file's bytes.
* ``convert-weights`` then ``run --weights out.msgpack`` writes the
  master CSV that ``run --weights w.pt --yolo-scale n`` writes, on a
  synthetic KITTI-360 tree of the two committed camera frames.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from lidar_object_detection_tpu.models.yolo import weights as jweights
from lidar_object_detection_tpu.models.yolo.model import (
    Yolo11 as JYolo11, YoloConfig as JConfig)
from lidar_object_detection_tpu_torch import config as tconfig
from lidar_object_detection_tpu_torch.config import ShapeConfig
from lidar_object_detection_tpu_torch.models.yolo import weights
from lidar_object_detection_tpu_torch.models.yolo.detector import (
    YoloDetector)
from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig
from lidar_object_detection_tpu_torch.pipelines import cli
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    packb, read_flax_msgpack, write_flax_msgpack)
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

CKPT = "checkpoints/yolo11n_seg_distill.msgpack"


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def detect_variables(variables):
    """The detection half of a segment tree as a segment=False tree."""
    out = {}
    for collection, tree in variables.items():
        tree = dict(tree)
        tree["head"] = dict(tree["head"]["detect"])
        out[collection] = tree
    return out


def ultralytics_state_dict(variables):
    """An ultralytics-keyed state dict of a Flax tree, by the JAX
    package's own mapping (torch layouts: OIHW kernels), with the DFL
    projection and the BN step counters of a real checkpoint."""
    sd = {}
    for (collection, *path), value in _leaves(variables):
        stem, leaf = jweights._flax_path_to_torch_key(tuple(path))
        key, _ = jweights._leaf_key_and_transform(stem, leaf, collection)
        value = np.asarray(value, np.float32)
        if leaf == "kernel" and not stem.endswith("upsample"):
            value = np.transpose(value, (3, 2, 0, 1))
        sd[key] = value
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                np.array(0, np.int64)
    sd["model.23.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(
        1, 16, 1, 1)
    return sd


@pytest.fixture(scope="module")
def ckpt_variables():
    return read_flax_msgpack(CKPT)["variables"]


@pytest.mark.parametrize("segment", [True, False])
def test_convert_state_dict_equals_jax(ckpt_variables, segment):
    variables = ckpt_variables if segment else detect_variables(
        ckpt_variables)
    sd = ultralytics_state_dict(variables)
    ref = jweights.convert_state_dict(
        sd, jax.tree_util.tree_map(jnp.asarray, variables))
    got = weights.convert_state_dict(
        sd, weights.flax_template(YoloConfig(scale="n", segment=segment)))
    ref_leaves = dict(_leaves(ref))
    got_leaves = dict(_leaves(got))
    assert sorted(got_leaves) == sorted(ref_leaves)
    for path, value in ref_leaves.items():
        assert got_leaves[path].dtype == np.float32
        np.testing.assert_array_equal(got_leaves[path], np.asarray(value))
    # the conversion inverts the mapping: the checkpoint comes back
    for path, value in _leaves(variables):
        np.testing.assert_array_equal(got_leaves[path], value)


@pytest.mark.parametrize("segment", [True, False])
def test_template_has_the_flax_init_tree(segment):
    shapes = jax.eval_shape(lambda: JYolo11(JConfig(
        scale="n", segment=segment)).init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 64, 64, 3))))
    ref = {tuple(k.key for k in path): tuple(x.shape) for path, x in
           jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {path: tuple(v.shape) for path, v in _leaves(
        weights.flax_template(YoloConfig(scale="n", segment=segment)))}
    assert got == ref


def test_convert_state_dict_lists_what_does_not_map(ckpt_variables):
    sd = ultralytics_state_dict(ckpt_variables)
    del sd["model.0.conv.weight"]
    sd["model.9.cv1.conv.weight"] = sd["model.9.cv1.conv.weight"][:1]
    sd["model.99.extra.weight"] = np.zeros(3, np.float32)
    template = weights.flax_template(YoloConfig(scale="n"))
    with pytest.raises(ValueError) as got:
        weights.convert_state_dict(sd, template)
    with pytest.raises(ValueError) as ref:
        jweights.convert_state_dict(
            sd, jax.tree_util.tree_map(jnp.asarray, ckpt_variables))
    msg = str(got.value)
    assert msg == str(ref.value)
    assert "missing in state dict: model.0.conv.weight" in msg
    assert "shape mismatch model.9.cv1.conv.weight" in msg
    assert "'model.99.extra.weight'" in msg


def test_torch_save_round_trip_and_pickled_class(ckpt_variables, tmp_path):
    sd = ultralytics_state_dict(ckpt_variables)
    path = str(tmp_path / "w.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got = weights.load_state_dict_file(path)
    ref = jweights.load_state_dict_file(path)
    assert sorted(got) == sorted(ref) == sorted(sd)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype
        np.testing.assert_array_equal(got[key], value)
    pickled = str(tmp_path / "full.pt")
    torch.save({"model": torch.nn.Linear(2, 2)}, pickled)
    with pytest.raises(ValueError, match="ultralytics package"):
        weights.load_state_dict_file(pickled)


def test_msgpack_writer_is_read_back(tmp_path, ckpt_variables):
    tree = {"variables": {"params": {"a": np.arange(6, dtype=np.float32)
                                     .reshape(2, 3),
                                     "b": torch.ones(3,
                                                     dtype=torch.bfloat16)},
                          "stats": {"n": np.int64(-7)}},
            "step": 12, "name": "x" * 40, "ok": True}
    path = str(tmp_path / "t.msgpack")
    write_flax_msgpack(path, tree)
    with open(path, "rb") as f:
        data = f.read()
    ref = serialization.msgpack_restore(data)
    got = read_flax_msgpack(path)
    for restored in (ref, got):
        assert restored["step"] == 12 and restored["name"] == "x" * 40
        assert restored["ok"] is True
        np.testing.assert_array_equal(
            np.asarray(restored["variables"]["params"]["a"]),
            tree["variables"]["params"]["a"])
        assert int(restored["variables"]["stats"]["n"]) == -7
    assert str(ref["variables"]["params"]["b"].dtype) == "bfloat16"
    assert got["variables"]["params"]["b"].dtype == torch.bfloat16
    # flax's own encoding, byte for byte
    with open(CKPT, "rb") as f:
        assert packb(read_flax_msgpack(CKPT)) == f.read()


# ---------------------------------------------------------------------------
# convert-weights, then --weights
# ---------------------------------------------------------------------------

H, W = chip_smoke.H0, chip_smoke.W0
SMALL = ShapeConfig(max_points=8192, max_detections=32, max_boxes=48,
                    image_height=H, image_width=W)


@pytest.fixture
def yolo_tree(tmp_path, ckpt_variables):
    """The two committed camera frames with scenes behind the n
    checkpoint's detections (as ``test_torch_pipeline.py`` builds them)."""
    images = np.stack([read_png_rgb(p) for p in chip_smoke.FRAMES])
    det = YoloDetector((H, W), YoloConfig(scale="n"),
                       variables=ckpt_variables, device="cpu").detect(images)
    assert det["det_valid"].sum() >= 4
    rng = np.random.default_rng(2)
    frames = []
    for b, image in enumerate(images):
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, det["boxes"][b].numpy(), det["det_valid"][b].numpy(),
            num_points=SMALL.max_points, num_boxes=48, num_valid=40)
        frames.append((100 + b, chip_smoke.FRAMES[b], points[pvalid],
                       corners[bvalid]))
    root = str(tmp_path / "tree")
    chip_smoke.write_kitti360_tree(root, frames)
    return root


def test_convert_weights_then_run_writes_the_pt_run_csv(
        yolo_tree, tmp_path, ckpt_variables, monkeypatch, capsys):
    orig = tconfig.FusionConfig.for_version
    monkeypatch.setattr(tconfig.FusionConfig, "for_version", staticmethod(
        lambda v: dataclasses.replace(orig(v), shapes=SMALL)))
    pt = str(tmp_path / "w.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                ultralytics_state_dict(ckpt_variables).items()}, pt)
    out = str(tmp_path / "conv" / "yolo11n.msgpack")
    assert cli.main(["convert-weights", "--state-dict", pt, "--output", out,
                     "--scale", "n", "--image-shape", str(H), str(W)]) == 0
    assert "converted" in capsys.readouterr().out
    with open(out + ".json") as f:
        assert json.load(f) == {"scale": "n"}
    with open(out, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    assert sorted(restored) == ["variables"]
    for path, value in _leaves(ckpt_variables):
        got = restored["variables"]
        for key in path:
            got = got[key]
        np.testing.assert_array_equal(got, value)

    csv = {}
    for name, argv in (("msgpack", ["--weights", out]),
                       ("pt", ["--weights", pt, "--yolo-scale", "n"])):
        run_dir = str(tmp_path / name)
        assert cli.main(["run", "--dataset", yolo_tree, "--version",
                         "csv_eval", "--detector", "yolo", *argv,
                         "--output", run_dir, "--device", "cpu"]) == 0
        with open(os.path.join(run_dir, "master_car_statistics.csv")) as f:
            # the last column is the time of writing
            csv[name] = [line.rsplit(",", 1)[0]
                         for line in f.read().splitlines()]
    assert csv["msgpack"] == csv["pt"]
    assert len(csv["pt"]) > 2
