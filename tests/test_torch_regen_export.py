"""The port's artifact regeneration, target oracle, ``yolo-export`` and
``forward_times --top-ops`` against the JAX package's example scripts, on
the CPU.

The tree is a synthetic KITTI-360 tree at 376 x 1408 of two frames, each
with a scan of boxes behind the n checkpoint's cars: frame 100, the
committed camera frame with the most cars, and frame 101, the other
committed frame.  The erosion study and the master CSVs run both frames
in one batch, the depth maps, the overlays and the V5 check frame 100
alone; the configs of both packages are pinned to 8192 points and 48
boxes.

* ``pipelines/regen_artifacts.py`` against ``examples/regen_artifacts.py``
  with the committed n checkpoint at its sidecar point (float32, hflip
  TTA, guarded): the erosion-study CSV and ``summary.json`` byte for byte,
  the workbook part by part (the zip's member stamps are the time of
  writing), the two master CSVs row by row but for the timestamp column,
  the printed lines, the overlays pixel for pixel (PIL writes the JAX
  script's PNG files, ``utils/png.py`` the port's), and the depth maps by
  name (the JAX figure is matplotlib's, the port's its two panels);
* ``build_detector``'s precedence, as ``tests/test_checkpoints.py``
  pins the JAX script's: sidecar, then explicit arguments;
* ``--eval-targets`` against ``examples/eval_distill_targets.py`` on the
  same label cache: the oracle's packed words bit for bit and the
  aggregates' lines;
* ``yolo-export`` against ``examples/export_yolo_ckpt.py``: bf16 and
  float32, with the EMA copy and without, with a serving block, a kept
  one and none, with and without a source sidecar: the checkpoint and the
  sidecar byte for byte and the printed lines; and the three refusals;
* ``tools/forward_times.py --top-ops`` on the CPU (the JAX script parses a
  TPU trace, so it has no CPU counterpart to hold it to).
"""

import dataclasses
import importlib.util
import json
import os
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from lidar_object_detection_tpu import config as jconfig
from lidar_object_detection_tpu.utils import cache as jcache
from lidar_object_detection_tpu_torch import config as tconfig
from lidar_object_detection_tpu_torch.models.yolo.serving import (
    load_serving_checkpoint)
from lidar_object_detection_tpu_torch.pipelines import (
    cli, regen_artifacts, yolo_distill)
from lidar_object_detection_tpu_torch.tools import forward_times
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack)
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
CKPT = "checkpoints/yolo11n_seg_distill.msgpack"
SHAPES = dict(max_points=8192, max_detections=32, max_boxes=48,
              image_height=376, image_width=1408)


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for the port's CPU twins while the module
    runs: beside the other test workers and XLA's own pool, more threads
    only contend for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pinned():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jconfig, tconfig):
            orig = mod.FusionConfig.for_version
            shapes = mod.ShapeConfig(**SHAPES)
            mp.setattr(mod.FusionConfig, "for_version", staticmethod(
                lambda v, orig=orig, shapes=shapes: dataclasses.replace(
                    orig(v), shapes=shapes)))
        mp.setattr(jcache, "enable_compilation_cache", lambda: None)
        yield mp


@pytest.fixture(scope="module")
def tree(tmp_path_factory, pinned):
    paths = (chip_smoke.FRAMES[1], chip_smoke.FRAMES[0])
    images = np.stack([read_png_rgb(path) for path in paths])
    det, _, _ = load_serving_checkpoint(CKPT, device="cpu")
    first = det.detect(images)
    rng = np.random.default_rng(1)
    frames = []
    for b, path in enumerate(paths):
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, first["boxes"][b].numpy(), first["det_valid"][b].numpy(),
            num_points=SHAPES["max_points"], num_boxes=SHAPES["max_boxes"],
            num_valid=40)
        frames.append((100 + b, path, points[pvalid], corners[bvalid]))
    root = str(tmp_path_factory.mktemp("regen_tree"))
    chip_smoke.write_kitti360_tree(root, frames)
    return root


# ---------------------------------------------------------------------------
# the regeneration
# ---------------------------------------------------------------------------

def test_regeneration_matches_jax(tree, tmp_path, monkeypatch, capsys):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    example = _load_example("regen_artifacts")
    monkeypatch.setattr(sys, "argv", ["x", "--ckpt", CKPT, "--dataset",
                                      tree, "--out", jout])
    monkeypatch.delenv("LIDAR_TPU_PLATFORM", raising=False)
    example.main()
    ref = capsys.readouterr().out
    assert regen_artifacts.main(["--ckpt", CKPT, "--dataset", tree,
                                 "--out", tout, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == ref
    assert "no image for overlay frames [2033]" in got

    for name in ("erosion_study.csv", "summary.json"):
        assert _read(os.path.join(tout, name)) == \
            _read(os.path.join(jout, name)), name
    summary = json.loads(_read(os.path.join(tout, "summary.json")))
    assert summary["erosion_study"]["matched_cars"] >= 4
    assert summary["v5_frame100_matched_pairs"] >= 1
    book = "master_car_statistics.csv.xlsx"
    with zipfile.ZipFile(os.path.join(jout, book)) as a, \
            zipfile.ZipFile(os.path.join(tout, book)) as b:
        assert b.namelist() == a.namelist()
        for member in a.namelist():
            assert b.read(member) == a.read(member), member
    for name in ("master_car_statistics.csv",
                 "master_car_statistics_raw.csv"):
        rows = [[line.rsplit(",", 1)[0] for line in _read(
            os.path.join(d, name)).decode().splitlines()]
            for d in (jout, tout)]
        assert rows[1] == rows[0] and len(rows[0]) > 4, name

    (overlay,) = os.listdir(os.path.join(jout, "seg_overlays"))
    assert os.listdir(os.path.join(tout, "seg_overlays")) == [overlay]
    np.testing.assert_array_equal(
        read_png_rgb(os.path.join(tout, "seg_overlays", overlay)),
        read_png_rgb(os.path.join(jout, "seg_overlays", overlay)))
    maps = sorted(os.listdir(os.path.join(tout, "depth_maps")))
    assert maps and maps == sorted(os.listdir(os.path.join(jout,
                                                           "depth_maps")))
    assert read_png_rgb(os.path.join(tout, "depth_maps", maps[0])).shape \
        == (2 * 376, 1408, 3)


def test_build_detector_takes_the_sidecar_then_the_arguments():
    """The committed sidecar's point (0.99, floor 0.5 at 200 px, hflip)
    unless an argument overrides a knob, as the JAX script's
    ``build_detector``; and the card unless ``device`` says otherwise."""
    example = _load_example("regen_artifacts")
    for kw in ({}, {"mask_threshold": 0.5, "tta": "none"},
               {"mask_threshold_floor": 0.3, "mask_min_pixels": 50}):
        det, step = regen_artifacts.build_detector(CKPT, device="cpu", **kw)
        jdet, jstep = example.build_detector(CKPT, **kw)
        assert step == jstep == 12000
        assert det.tta == jdet.tta
        for knob in ("mask_threshold", "mask_threshold_floor",
                     "mask_min_pixels", "conf_threshold"):
            assert getattr(det.params, knob) == getattr(jdet.params, knob)
    det, _ = regen_artifacts.build_detector(CKPT, device="cpu")
    assert (det.params.mask_threshold, det.params.mask_threshold_floor,
            det.params.mask_min_pixels, det.tta) == (0.99, 0.5, 200, "hflip")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            regen_artifacts.build_detector(CKPT)


# ---------------------------------------------------------------------------
# the target oracle
# ---------------------------------------------------------------------------

def test_eval_targets_matches_jax(tree, tmp_path, monkeypatch, capsys):
    """Both serve the same label cache (the JAX runner builds it) through
    the erosion study: the oracle's words and the aggregates' lines."""
    cache = str(tmp_path / "labels.npz")
    example = _load_example("eval_distill_targets")
    monkeypatch.setattr(sys, "argv", ["x", "--dataset", tree, "--cache",
                                      cache])
    monkeypatch.syspath_prepend(REPO)
    example.main()
    ref = capsys.readouterr().out.splitlines()
    assert yolo_distill.main(["--dataset", tree, "--eval-targets",
                              "--cache", cache, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0] == f"[labels] cached <- {cache}"
    assert got[1:] == ref[-4:]
    assert "'matched_cars': 0" not in got[1]

    labels = dict(np.load(cache))
    from lidar_object_detection_tpu.data import Kitti360Dataset
    records = Kitti360Dataset(tree).load_frames()
    words = yolo_distill.TargetOracleDetector(labels).detect_records(
        records)
    jwords = example.TargetOracleDetector(labels).detect_records(records)
    for key in ("boxes", "scores", "det_valid"):
        np.testing.assert_array_equal(words[key], jwords[key])
    assert words["mask_bits"].dtype == np.int32
    np.testing.assert_array_equal(words["mask_bits"],
                                  jwords["mask_bits"].view(np.int32))
    assert (words["mask_bits"] != 0).any()


# ---------------------------------------------------------------------------
# yolo-export
# ---------------------------------------------------------------------------

def _source(tmp_path, ema: bool, sidecar: bool) -> str:
    """A distillation run's checkpoint: the committed n variables, step 7,
    and with ``ema`` an EMA copy, a few of its leaves already bf16."""
    raw = serialization.msgpack_restore(_read(CKPT))
    payload = {"variables": raw["variables"], "step": np.asarray(7)}
    if ema:
        def nudge(tree, path=""):
            if isinstance(tree, dict):
                return {k: nudge(v, f"{path}/{k}") for k, v in tree.items()}
            if path.endswith("bn/bias"):
                return np.asarray(tree * 1.5, jnp.bfloat16)
            return tree * np.float32(1.001)
        payload["ema_variables"] = nudge(raw["variables"])
    src = str(tmp_path / "run.msgpack")
    with open(src, "wb") as f:
        f.write(serialization.msgpack_serialize(payload))
    if sidecar:
        with open(src + ".json", "w") as f:
            json.dump({"model": "yolo11-seg", "scale": "n",
                       "num_classes": 80, "image_size": [192, 640],
                       "step": 7}, f)
    return src


EXPORTS = {
    "bf16, EMA, serving block": (
        True, True, ["--serving-mask-thr", "0.99", "--serving-mask-floor",
                     "0.5", "--serving-mask-min-pixels", "200",
                     "--serving-tta", "hflip"]),
    "f32, no EMA, no serving block": (False, True, ["--dtype", "float32"]),
    "bf16, no sidecar, a cut only": (False, False,
                                     ["--serving-mask-thr", "0.9"]),
    "f32, EMA, no sidecar": (True, False, ["--dtype", "float32"]),
}


@pytest.mark.parametrize("case", list(EXPORTS))
def test_yolo_export_is_byte_equal_to_jax(case, tmp_path, monkeypatch,
                                          capsys):
    ema, sidecar, flags = EXPORTS[case]
    src = _source(tmp_path, ema, sidecar)
    ref, got = str(tmp_path / "ref.msgpack"), str(tmp_path / "got.msgpack")
    example = _load_example("export_yolo_ckpt")
    monkeypatch.setattr(sys, "argv", ["x", src, ref, *flags])
    example.main()
    ref_text = capsys.readouterr().out.replace(ref, got)
    assert cli.main(["yolo-export", src, got, *flags]) == 0
    assert capsys.readouterr().out == ref_text
    assert _read(got) == _read(ref)
    assert os.path.exists(got + ".json") == os.path.exists(ref + ".json")
    if os.path.exists(ref + ".json"):
        assert _read(got + ".json") == _read(ref + ".json")
    out = read_flax_msgpack(got)
    assert set(out) == {"variables", "step"} and int(out["step"]) == 7
    if sidecar and "--serving-mask-thr" in flags:
        det, step, resolved = load_serving_checkpoint(got, device="cpu")
        assert step == 7 and resolved["tta"] == "hflip" \
            and resolved["mask_threshold_floor"] == 0.5


REFUSALS = {
    "tta without a cut": ["--serving-tta", "hflip"],
    "floor without a cut": ["--serving-mask-floor", "0.5",
                            "--serving-mask-min-pixels", "200"],
    "floor without a guard": ["--serving-mask-thr", "0.99",
                              "--serving-mask-floor", "0.5"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_yolo_export_refuses_as_jax(case, tmp_path, monkeypatch, capsys):
    src = _source(tmp_path, False, True)
    dst = str(tmp_path / "dst.msgpack")
    example = _load_example("export_yolo_ckpt")
    monkeypatch.setattr(sys, "argv", ["x", src, dst, *REFUSALS[case]])
    with pytest.raises(SystemExit) as ref:
        example.main()
    ref_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        cli.main(["yolo-export", src, dst, *REFUSALS[case]])
    got_err = capsys.readouterr().err.splitlines()[-1]
    assert ref.value.code == got.value.code == 2
    assert got_err.split(": error: ")[1] == ref_err.split(": error: ")[1]
    assert not os.path.exists(dst)


# ---------------------------------------------------------------------------
# the detector profile
# ---------------------------------------------------------------------------

def test_forward_times_top_ops_on_the_cpu(tmp_path, capsys):
    trace = str(tmp_path / "trace")
    assert forward_times.main(["--top-ops", "4", "--batch", "1", "--scale",
                               "n", "--iters", "1", "--device", "cpu",
                               "--trace-dir", trace]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("detect: ") and "batch 1) on cpu" in lines[0]
    top = lines.index("-- top 4 individual ops --")
    assert any(line.startswith("== device: cpu") for line in lines)
    assert len(lines[top + 1:]) == 4
    assert all(line.rstrip().endswith(" ms") for line in lines[top + 1:])
    assert os.path.getsize(os.path.join(trace, "trace.json")) > 0
    if not torch.cuda.is_available():
        assert forward_times.main(["--top-ops", "4"]) == 1
    # the times mode times the card only
    with pytest.raises(SystemExit) as refused:
        forward_times.main(["--repo", str(tmp_path), "--device", "cpu"])
    assert refused.value.code == 2
    assert "--device cpu is for --top-ops" in capsys.readouterr().err
