"""The port's csv_eval, v2_stats and erosion-study entry points, and its
CLI, against the JAX package's on a synthetic KITTI-360 tree written into
a temporary directory, on the CPU.

* With the stub detector the outputs are equal byte for byte: the master
  CSV (a fixed timestamp given to both), the ``analyze_master_csv`` dict,
  the erosion-study CSV and every part of the workbook.  The JAX package
  reads the CSV with pandas, the port with ``csv`` and numpy.
* With the committed n checkpoint in float32, on two 96 x 320 crops of a
  camera frame served at ``imgsz=160`` (as ``test_torch_slice.py`` serves
  them), each package's ``csv_eval`` gets one detector object.  Detections
  hold the slice test's tolerances (boxes 1e-3 px, scores 1e-5, equal
  validity, at most 1e-3 of the mask words differing); the rows are equal
  when both fusions take the JAX mask words.
* The CLI on ``--device cpu`` writes what the function API writes.

The erosion study and the CLI read each version's config from
``FusionConfig.for_version``; the tests pin it to small shapes in both
packages so that the runs stay short.
"""

import dataclasses
import os
import types
import zipfile

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu import config as jconfig
from lidar_object_detection_tpu.config import FusionConfig as JFusionConfig
from lidar_object_detection_tpu.config import PipelineVersion as JVersion
from lidar_object_detection_tpu.data.kitti360 import (
    Kitti360Dataset as JDataset)
from lidar_object_detection_tpu.eval import statistics as jstats
from lidar_object_detection_tpu.eval.erosion_study import (
    run_erosion_study as jrun_erosion_study)
from lidar_object_detection_tpu.eval.xlsx import read_xlsx as jread_xlsx
from lidar_object_detection_tpu.models.yolo.serving import (
    load_serving_checkpoint as jload)
from lidar_object_detection_tpu.pipelines import runner as jrunner
from lidar_object_detection_tpu_torch import config as tconfig
from lidar_object_detection_tpu_torch.config import (
    FusionConfig, PipelineVersion, ShapeConfig)
from lidar_object_detection_tpu_torch.data import Kitti360Dataset
from lidar_object_detection_tpu_torch.eval.erosion_study import (
    run_erosion_study)
from lidar_object_detection_tpu_torch.eval.statistics import (
    analyze_master_csv, format_summary_table)
from lidar_object_detection_tpu_torch.eval.xlsx import read_xlsx
from lidar_object_detection_tpu_torch.models.yolo.serving import (
    load_serving_checkpoint)
from lidar_object_detection_tpu_torch.pipelines import cli, runner
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

CKPT = "checkpoints/yolo11n_seg_distill.msgpack"
H, W = 96, 320
K = np.array([[140.0, 0.0, 160.0], [0.0, 140.0, 48.0], [0.0, 0.0, 1.0]])
SHAPES = dict(max_points=8192, max_detections=32, max_boxes=48,
              image_height=H, image_width=W)
SMALL, JSMALL = ShapeConfig(**SHAPES), jconfig.ShapeConfig(**SHAPES)
STAMP = "2026-01-01T00:00:00"


def _write_tree(root, images, det_boxes, det_valid, seed):
    """Frames 100, 101, ... with scenes behind ``det_boxes``, and frame 99
    without a box JSON."""
    rng = np.random.default_rng(seed)
    frames = []
    for b, image in enumerate(images):
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, det_boxes[b], det_valid[b], num_points=SHAPES["max_points"],
            num_boxes=48, num_valid=40, intrinsics=K)
        frames.append((100 + b, image, points[pvalid], corners[bvalid]))
    frames.append((99, images[0], frames[0][2], None))
    chip_smoke.write_kitti360_tree(str(root), frames, K, W, H)
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    x1 = rng.uniform(0, W - 70, (3, 5))
    y1 = rng.uniform(10, H - 45, (3, 5))
    boxes = np.stack([x1, y1, x1 + 60, y1 + 35], -1)
    return _write_tree(tmp_path_factory.mktemp("stub_tree"), images, boxes,
                       np.ones((3, 5), bool), seed=1)


@pytest.fixture
def pinned(monkeypatch):
    """Both packages' per-version configs at the small shapes, and the JAX
    master-CSV writer's clock at STAMP."""
    for mod, shapes in ((jconfig, JSMALL), (tconfig, SMALL)):
        orig = mod.FusionConfig.for_version
        monkeypatch.setattr(mod.FusionConfig, "for_version", staticmethod(
            lambda v, orig=orig, shapes=shapes: dataclasses.replace(
                orig(v), shapes=shapes)))
    now = types.SimpleNamespace(isoformat=lambda: STAMP)
    monkeypatch.setattr(jstats, "datetime", types.SimpleNamespace(
        datetime=types.SimpleNamespace(now=lambda: now)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _parts(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def test_csv_eval_stub_matches_jax(tree, tmp_path, pinned):
    jpath, tpath = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    ref = jrunner.csv_eval(tree, jpath, shapes=JSMALL)
    got = runner.csv_eval(tree, tpath, device="cpu", timestamp=STAMP,
                          shapes=SMALL)
    assert _read(tpath) == _read(jpath)
    assert got == ref
    assert analyze_master_csv(jpath) == jstats.analyze_master_csv(tpath)
    assert ref["total_frames"] == 3 and ref["matched"] > 5
    assert ref["unmatched"] > 0 or ref["match_rate"] == 100.0


@pytest.mark.parametrize("version", ["v2_stats", "v1_pointwise"])
def test_runs_stub_match_jax(tree, version):
    jcfg = dataclasses.replace(JFusionConfig.for_version(JVersion(version)),
                               shapes=JSMALL)
    cfg = dataclasses.replace(
        FusionConfig.for_version(PipelineVersion(version)), shapes=SMALL)
    ref = jrunner.FusionPipeline(JDataset(tree, shapes=JSMALL), jcfg).run()
    got = runner.FusionPipeline(Kitti360Dataset(tree, shapes=SMALL), cfg,
                                device="cpu").run()
    assert [vars(r) for r in got.csv_rows] == [vars(r) for r in ref.csv_rows]
    assert got.summary() == ref.summary()
    assert format_summary_table(got.csv_rows) == \
        jstats.format_summary_table(ref.csv_rows)
    for a, b in zip(got.frames, ref.frames, strict=True):
        assert (a.frame_id, a.num_detections, a.num_visible_boxes) == \
            (b.frame_id, b.num_detections, b.num_visible_boxes)
        assert len(a.matched_pairs) == len(b.matched_pairs)
        for p, q in zip(a.matched_pairs, b.matched_pairs):
            assert {k: p[k] for k in ("detection", "box_index",
                                      "point_count")} == \
                {k: q[k] for k in ("detection", "box_index", "point_count")}
            np.testing.assert_array_equal(p["corners_velo"],
                                          np.asarray(q["corners_velo"]))


def test_erosion_study_stub_matches_jax(tree, tmp_path, pinned):
    out = {}
    for name, fn, kw in (("j", jrun_erosion_study, {}),
                         ("t", run_erosion_study, {"device": "cpu"})):
        csv_path = str(tmp_path / name / "erosion_study.csv")
        xlsx_path = str(tmp_path / name / "study.xlsx")
        result = fn(tree, output_csv=csv_path, output_xlsx=xlsx_path, **kw)
        out[name] = (result, _read(csv_path), _parts(xlsx_path), xlsx_path)
    (jres, jcsv, jparts, jxlsx), (tres, tcsv, tparts, txlsx) = (out["j"],
                                                                out["t"])
    assert tcsv == jcsv
    assert tparts == jparts
    assert tres.summary() == jres.summary()
    assert [vars(r) for r in tres.rows] == [vars(r) for r in jres.rows]
    assert read_xlsx(txlsx) == jread_xlsx(jxlsx)
    assert len(tres.rows) > 5 and tres.std_inside_pct_diff > 0


def test_cli_writes_what_the_function_api_writes(tree, tmp_path, pinned):
    cli_out = str(tmp_path / "cli")
    assert cli.main(["run", "--dataset", tree, "--version", "csv_eval",
                     "--output", cli_out, "--device", "cpu"]) == 0
    assert cli.main(["erosion-study", "--dataset", tree, "--output", cli_out,
                     "--device", "cpu"]) == 0
    api_csv = str(tmp_path / "api" / "master_car_statistics.csv")
    runner.csv_eval(tree, api_csv, device="cpu", timestamp=STAMP)
    strip = lambda text: [line.rsplit(",", 1)[0]
                          for line in text.decode().splitlines()]
    cli_csv = os.path.join(cli_out, "master_car_statistics.csv")
    assert strip(_read(cli_csv)) == strip(_read(api_csv))
    assert len(strip(_read(cli_csv))) > 5
    api_out = str(tmp_path / "api")
    run_erosion_study(
        tree, output_csv=os.path.join(api_out, "erosion_study.csv"),
        output_xlsx=os.path.join(api_out, "master_car_statistics.csv.xlsx"),
        device="cpu")
    assert _read(os.path.join(cli_out, "erosion_study.csv")) == \
        _read(os.path.join(api_out, "erosion_study.csv"))
    # the zip stamps each part with the time of writing: compare the parts
    assert _parts(os.path.join(cli_out, "master_car_statistics.csv.xlsx")) \
        == _parts(os.path.join(api_out, "master_car_statistics.csv.xlsx"))


@pytest.mark.parametrize("argv", [
    ["pointpillars-train", "--dataset", "x", "--head", "center",
     "--aggregate-sweeps"],
    ["pointpillars-train", "--dataset", "x", "--steps", "2"],
    ["kitti2d", "--dataset", "x"],
    ["convert-weights", "--state-dict", "w.pt", "--output", "o"],
    ["run", "--dataset", "TREE", "--version", "v4_iou", "--detector",
     "yolo", "--weights", "w.pt", "--device", "cpu"],
    ["depth-maps", "--dataset", "TREE", "--detector", "yolo", "--weights",
     "orbax_dir", "--device", "cpu"],
    ["erosion-study", "--dataset", "TREE", "--detector", "yolo",
     "--weights", "w.safetensors", "--device", "cpu"],
    ["run", "--dataset", "TREE", "--detector", "yolo", "--weights",
     "w.safetensors", "--device", "cpu"],
])
def test_cli_refuses_what_is_not_ported(tree, argv):
    argv = [tree if a == "TREE" else a for a in argv]
    with pytest.raises(SystemExit, match="ROADMAP Queue 1 item"):
        cli.main(argv)


def test_pipeline_runs_on_cuda_by_default_or_refuses(tree):
    ds = Kitti360Dataset(tree, shapes=SMALL)
    cfg = FusionConfig.for_version(PipelineVersion.CSV_EVAL)
    if torch.cuda.is_available():
        assert runner.FusionPipeline(ds, cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.FusionPipeline(ds, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.FusionPipeline(
            ds, FusionConfig.for_version(PipelineVersion.V5_PROJECTED))
    v5 = runner.FusionPipeline(
        ds, FusionConfig.for_version(PipelineVersion.V5_PROJECTED),
        device="cpu")
    assert v5.device.type == "cpu"


# ---------------------------------------------------------------------------
# the n checkpoint in float32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yolo_tree(tmp_path_factory):
    frame = read_png_rgb(chip_smoke.FRAMES[0])
    images = np.ascontiguousarray(np.stack(
        [frame[180:276, 528:848], frame[180:276, 352:672]]))
    jdet, _, _ = jload(CKPT, (H, W), imgsz=160)
    first = {k: np.asarray(v) for k, v in jdet.detect(images).items()}
    root = _write_tree(tmp_path_factory.mktemp("yolo_tree"), images,
                       first["boxes"], first["det_valid"], seed=2)
    tdet, _, _ = load_serving_checkpoint(CKPT, (H, W), imgsz=160,
                                         device="cpu")
    return root, jdet, tdet


def test_csv_eval_with_the_n_checkpoint(yolo_tree, tmp_path, pinned):
    root, jdet, tdet = yolo_tree
    jcfg = dataclasses.replace(JFusionConfig.for_version(JVersion.CSV_EVAL),
                               shapes=JSMALL)
    cfg = FusionConfig.for_version(PipelineVersion.CSV_EVAL)
    jpipe = jrunner.FusionPipeline(JDataset(root, shapes=JSMALL), jcfg, jdet)
    tpipe = runner.FusionPipeline(Kitti360Dataset(root, shapes=SMALL), cfg,
                                  tdet, device="cpu")
    records = tpipe.dataset.load_frames()
    assert [r.frame_id for r in records] == [100, 101]
    batch = tpipe.dataset.make_batch(records)
    ref = jpipe.detect(jpipe.dataset.load_frames(),
                       jpipe.dataset.make_batch(jpipe.dataset.load_frames()))
    got = {k: v.numpy() for k, v in tpipe.detect(records, batch).items()}
    np.testing.assert_array_equal(got["det_valid"], ref["det_valid"])
    assert ref["det_valid"].sum() >= 3, "degenerate: too few cars"
    v = ref["det_valid"]
    np.testing.assert_allclose(got["boxes"][v], ref["boxes"][v], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0,
                               atol=1e-5)
    words = ref["mask_bits"].astype(np.uint32).view(np.int32)
    share = float((got["mask_bits"] != words).mean())
    assert share <= 1e-3, f"mask-word mismatch share {share}"

    # the JAX detections through both fusions: equal rows
    jrows = jpipe.run(detections=ref).csv_rows
    trows = tpipe.run(detections={
        "mask_bits": torch.from_numpy(words),
        "det_valid": torch.from_numpy(np.array(ref["det_valid"]))}).csv_rows
    assert [vars(r) for r in trows] == [vars(r) for r in jrows]
    assert sum(r.is_matched for r in jrows) >= 2

    # each package's csv_eval entry with its own detector object
    jpath, tpath = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jres = jrunner.csv_eval(root, jpath, detector=jdet, shapes=JSMALL)
    tres = runner.csv_eval(root, tpath, detector=tdet, device="cpu",
                           timestamp=STAMP, shapes=SMALL)
    if share == 0:
        assert _read(tpath) == _read(jpath)
        assert tres == jres
    else:
        assert tres["total_detections"] == jres["total_detections"]
