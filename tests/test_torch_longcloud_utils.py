"""The long-cloud fusion tool, ``erode_masks`` and
``utils/{profiling,debug}.py`` against the JAX package.

* ``pipelines/longcloud.py`` against ``examples/longcloud_demo.py`` at a
  small ``--min-points``: the same ``points`` and ``detections_points``;
* ``erode_masks``, ``coordinate_ranges``, ``assert_finite`` (its error)
  and the ``StageTimer`` report exactly as JAX's; the NaN guard, the
  throughput meter, the barrier and the trace on the CPU.

The JAX script is loaded with ``importlib`` and redirected only by
``monkeypatch``, as in ``test_torch_pillars_runs.py``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.ops import erosion as jerosion
from lidar_object_detection_tpu.utils import debug as jdebug
from lidar_object_detection_tpu.utils import profiling as jprofiling
from lidar_object_detection_tpu_torch.ops import erosion as terosion
from lidar_object_detection_tpu_torch.ops import kernel_lib
from lidar_object_detection_tpu_torch.pipelines import longcloud
from lidar_object_detection_tpu_torch.utils import debug, profiling
from test_torch_pillars_runs import _load_example, redirect, write_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("overfit_tree")),
                      frames=(100, 101, 102))


def test_longcloud_matches_jax(tree, monkeypatch, capsys):
    """``longcloud`` on the 3-sweep aggregate of the tree's last frame
    (its image written) reports JAX's ``points`` and
    ``detections_points``; fewer points than ``--min-points`` refuses."""
    img_dir = os.path.join(tree, "data_2d_raw", "2013_05_28_drive_0000_sync",
                           "image_00", "data_rect")
    from lidar_object_detection_tpu_torch.utils.png import write_png_rgb
    write_png_rgb(os.path.join(img_dir, "0000000102.png"),
                  np.zeros((chip_smoke.H0, chip_smoke.W0, 3), np.uint8))
    redirect(monkeypatch, tree)
    monkeypatch.setenv("LIDAR_TPU_KITTI360", tree)
    flags = ["--frame", "102", "--sweeps", "3", "--iters", "1",
             "--min-points", "4096"]
    example = _load_example("longcloud_demo")
    monkeypatch.setattr(sys, "argv", ["x", *flags])
    example.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    kernel_lib.reset_launches()
    assert longcloud.main([*flags, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got = json.loads(lines[-1])
    assert lines[-2] == "[longcloud] cpu"
    assert got.keys() == ref.keys()
    for key in ("metric", "points", "unit", "detections_points"):
        assert got[key] == ref[key], key
    assert got["detections_points"] > 0
    assert not any(kernel_lib.LAUNCHES.values())
    with pytest.raises(ValueError, match="fewer than --min-points"):
        longcloud.main([*flags[:-1], str(ref["points"] + 1),
                        "--device", "cpu"])


@pytest.mark.parametrize("kernel_size,iterations", [(3, 1), (5, 2)])
def test_erode_masks_matches_jax(kernel_size, iterations):
    rng = np.random.default_rng(kernel_size)
    masks = (rng.uniform(size=(5, 23, 37)) < 0.8).astype(np.float32)
    masks[1] = 1.0
    ref = np.asarray(jerosion.erode_masks(jnp.asarray(masks), kernel_size,
                                          iterations))
    for given in (torch.from_numpy(masks), torch.from_numpy(masks > 0.5)):
        got = terosion.erode_masks(given, kernel_size, iterations)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), ref)


def test_debug_helpers_match_jax():
    """``coordinate_ranges`` gives JAX's dict; ``assert_finite`` raises
    JAX's message (leaf path in ``keystr`` form, count) on a numpy tree
    and on the same tree of tensors, and passes a finite one."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 4)).astype(np.float32)
    corners = rng.normal(size=(3, 8, 3)).astype(np.float32)
    assert debug.coordinate_ranges(pts, corners) == \
        jdebug.coordinate_ranges(pts, corners)
    assert debug.coordinate_ranges(pts) == jdebug.coordinate_ranges(pts)
    bad = {"b": [np.ones(3, np.float32),
                 np.array([1.0, np.nan, np.inf], np.float32)],
           "a": {"x": np.arange(3), "y": np.zeros(2, np.float32)}}
    with pytest.raises(FloatingPointError) as ref:
        jdebug.assert_finite(bad, "state")
    as_tensors = jax.tree_util.tree_map(torch.from_numpy, bad)
    for tree in (bad, as_tensors):
        with pytest.raises(FloatingPointError) as got:
            debug.assert_finite(tree, "state")
        assert str(got.value) == str(ref.value) == \
            "state['b'][1]: 2 non-finite values"
    debug.assert_finite({"a": torch.ones(2), "n": None, "i": 3}, "ok")


def test_nan_guard_names_the_operation():
    """The guard passes finite work through and names the first
    operation that makes a NaN, as ``checkify_nan_guard`` names the
    primitive."""
    guarded = debug.nan_guard(lambda x: torch.log(x) * 2)
    torch.testing.assert_close(guarded(torch.tensor([1.0, 2.0])),
                               torch.log(torch.tensor([1.0, 2.0])) * 2)
    with pytest.raises(FloatingPointError, match="nan generated by "
                                                 "aten.log"):
        guarded(torch.tensor([-1.0, 2.0]))
    with pytest.raises(Exception, match="nan generated by primitive: log"):
        jdebug.checkify_nan_guard(lambda x: jnp.log(x) * 2)(
            jnp.array([-1.0, 2.0]))


def test_stage_timer_report_and_meters_match_jax(tmp_path):
    """The report of the same stage times is JAX's, character for
    character; a stage with a CPU tensor result ends without a card; the
    trace writes a Chrome trace."""
    times = {"fuse": 0.0123, "decode": 0.0045, "load": 0.25}
    counts = {"fuse": 3, "decode": 3, "load": 1}
    timers = [profiling.StageTimer(barrier=False),
              jprofiling.StageTimer(barrier=False)]
    for t in timers:
        t.times, t.counts = dict(times), dict(counts)
    assert timers[0].report() == timers[1].report()
    timer = profiling.StageTimer()
    with timer.stage("add") as h:
        h.append({"x": torch.ones(3) + 1})
    with timer.stage("add"):
        pass
    assert timer.counts == {"add": 2} and timer.times["add"] >= 0
    assert "TOTAL" in timer.report().splitlines()[-1]
    profiling.device_barrier([torch.ones(1), {"a": 1}])
    assert profiling.device_name("cpu") == "cpu"
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
