"""The reference against the port's CPU path, on the committed
checkpoints and frames, and its parameter and FLOP counts pinned.

The port's unfolded network computes its BatchNorm multiplier in the
dtype a checkpoint stores its statistics in, as Flax does; the x
checkpoint stores bfloat16, so the port's unfolded float32 x network
departs from the reference's float32 arithmetic by about 1-2 % of each
output's range, where the n checkpoint (float32) agrees to about 1e-6 of
it.  The x configuration serves with BatchNorm folded, and the fold
computes the multiplier in float32 from the stored statistics, as the
reference does: the network as each configuration states it, computed in
float32, agrees with the reference to about 1e-6 of each output's range
(``test_configured_network_agrees``), so what the comparison reads on the
card is the configuration's precision alone."""

import numpy as np
import pytest
import torch

from benchmark.harness import scene, traffic
from benchmark.harness.png import read_png_rgb
from benchmark.harness.spec import ROOT, load_cell, load_json
from benchmark.reference import decode as rd
from benchmark.reference import fusion as rf
from benchmark.reference import yolo as ry
from benchmark.reference.msgpack_reader import read_flax_msgpack
from lidar_object_detection_tpu_torch.config import FusionConfig, FusionParams
from lidar_object_detection_tpu_torch.config import PipelineVersion
from lidar_object_detection_tpu_torch.eval.statistics import frame_statistics
from lidar_object_detection_tpu_torch.fusion.associate import fuse_batch
from lidar_object_detection_tpu_torch.models.yolo.detector import YoloDetector
from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig
from benchmark.harness.system import row_tuples

# the largest output gap as a share of the output's largest magnitude
OUTPUT_TOL = {"n": 1e-5, "x": 0.04}
FRAME = "artifacts/learned_detector/seg_overlays/0000000100.png"


@pytest.fixture(scope="module", params=["n", "x"])
def both(request):
    scale = request.param
    var = read_flax_msgpack(
        f"{ROOT}/checkpoints/yolo11{scale}_seg_distill.msgpack")["variables"]
    tta = "hflip" if scale == "n" else "none"
    port = YoloDetector((376, 1408), YoloConfig(scale=scale), variables=var,
                        mask_threshold=0.99, mask_threshold_floor=0.5,
                        mask_min_pixels=200, tta=tta, device="cpu")
    ref = ry.load_reference(var, scale)
    params = rd.DecodeParams(spec=rd.LetterboxSpec.build(376, 1408, 640),
                             mask_threshold=0.99, mask_floor=0.5,
                             mask_min_pixels=200, tta=tta)
    return scale, port, ref, params


def test_network_outputs_agree(both):
    scale, port, ref, _ = both
    x = torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = port.model(x), ref(x)
    for key in ("box", "cls", "coef", "proto"):
        for a, b in zip(*((v if isinstance(v, list) else [v])
                          for v in (got[key], want[key]))):
            assert float((a - b).abs().max()) <= \
                OUTPUT_TOL[scale] * float(b.abs().max()), key


@pytest.mark.parametrize("workload", ["n_csv_tta_b64", "x_headline_b64"])
def test_configured_network_agrees(workload):
    config = load_cell(workload).config
    var = read_flax_msgpack(f"{ROOT}/{config['checkpoint']}")["variables"]
    port = YoloDetector((376, 1408), YoloConfig(scale=config["scale"]),
                        variables=var, fold_weights=config["fold_batchnorm"],
                        dtype=torch.float32, device="cpu")
    ref = ry.load_reference(var, config["scale"])
    x = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = port.model(x), ref(x)
    for key in ("box", "cls", "coef", "proto"):
        for a, b in zip(*((v if isinstance(v, list) else [v])
                          for v in (got[key], want[key]))):
            assert float((a - b).abs().max()) <= \
                1e-5 * float(b.abs().max()), key


def test_detections_agree_on_a_committed_frame(both):
    scale, port, ref, params = both
    frame = read_png_rgb(f"{ROOT}/{FRAME}")[None]
    got = port.detect(frame)
    want = rd.detect(ref, torch.from_numpy(frame), params)
    assert torch.equal(got["det_valid"], want["det_valid"])
    assert int(want["det_valid"].sum()) > 0
    box_tol, score_tol, word_tol = {"n": (1e-3, 1e-4, 0.0),
                                    "x": (0.5, 0.1, 0.005)}[scale]
    assert float((got["boxes"] - want["boxes"]).abs().max()) <= box_tol
    assert float((got["scores"] - want["scores"]).abs().max()) <= score_tol
    assert float((got["mask_bits"] != want["mask_bits"]).float().mean()) \
        <= word_tol


@pytest.mark.parametrize("workload", ["n_csv_tta_b64", "x_headline_b64"])
def test_the_reference_finds_cars_in_every_committed_frame(workload):
    cell = load_cell(workload)
    sources = cell.mix["frames"]["sources"]
    cars = traffic.load_cars(ROOT, cell.config["name"], sources)
    assert len(cars) == len(sources)
    assert all(len(boxes) for boxes in cars)


def test_fusion_and_rows_equal_the_ports():
    rng = np.random.default_rng(3)
    boxes = np.float32([[600, 150, 760, 260], [900, 160, 1100, 280]])
    pts, pv, corners, bv = scene.make_scene(
        rng, boxes, np.ones(2, bool), num_points=20000, num_boxes=64,
        num_valid=40, surround=True)
    words = np.zeros((376, 1408), np.int64)
    words[150:260, 600:760] |= 1
    words[160:280, 900:1100] |= 2
    words[200:240, 650:1000] |= 4
    words = ((words + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    det_valid = np.zeros(32, bool)
    det_valid[:3] = True
    calib = [torch.from_numpy(np.asarray(m, np.float32))
             for m in (scene.VELO_TO_RECT, scene.CAM_TO_VELO,
                       scene.INTRINSICS)]
    t = lambda a: torch.from_numpy(np.asarray(a))[None]
    params = FusionParams.from_config(
        FusionConfig.for_version(PipelineVersion.CSV_EVAL))
    port = fuse_batch(t(pts), t(pv), t(words), t(det_valid), t(corners),
                      t(bv), *calib, params)
    ref = rf.fuse_frame(torch.from_numpy(pts), torch.from_numpy(pv),
                        torch.from_numpy(words), torch.from_numpy(det_valid),
                        torch.from_numpy(corners), torch.from_numpy(bv),
                        *calib, width=1408, height=376, depth_min=0.0,
                        depth_max=50.0, min_points=10)
    for key, value in ref.items():
        assert torch.equal(port[key][0], value), key
    assert int(ref["matched"].sum()) >= 2
    got = row_tuples(frame_statistics(
        0, port["total_points"][0], port["best_box"][0],
        port["points_inside"][0], port["matched"][0], det_valid,
        port["box_visible"][0]))
    want = rf.frame_rows(0, {k: v.numpy() for k, v in ref.items()},
                         det_valid)
    assert got == want and len(want) == 3


@pytest.mark.parametrize("name, params, flops_640, flops_view", [
    ("yolo11n-seg", 2_876_832, 9_738_764_800, 2_921_629_440),
    ("yolo11x-seg", 62_142_640, 296_362_291_200, 88_908_687_360),
])
def test_parameter_and_flop_counts(name, params, flops_640, flops_view):
    config = load_json("configs", name)
    with torch.device("meta"):
        model = ry.Yolo11Seg(config["scale"])
    assert ry.parameter_count(model) == params
    assert ry.conv_flops(model, (640, 640)) == flops_640
    assert ry.conv_flops(model, (192, 640)) == flops_view
    # Ultralytics' published counts at 640 x 640
    assert abs(params / config["published"]["params"] - 1) < 0.02
    assert 0.9 < flops_640 / 1e9 / config["published"]["gflops_640"] < 1.0
