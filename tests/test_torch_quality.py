"""The port's serving-quality protocol (``pipelines/quality.py``) against
the JAX package's example scripts, on the CPU.

The tree is a synthetic KITTI-360 tree of frames 100-102 at 376 x 1408
(``chip_smoke.quality_tree``): the two committed camera frames and the
first one mirrored, each with a scan of boxes behind the n checkpoint's
own cars.  Both packages' per-version configs are pinned to 8192 points
and 48 boxes, so that the fusions stay short.  The committed n checkpoint
serves in float32.

* ``prepare_study``: the raw network outputs within 1e-3 (the float32
  network sums in other orders; measured up to 6e-4);
* the four subcommands against ``quality_knob_sweep.py``,
  ``quality_threshold_cv.py``, ``quality_flip_probe.py`` and
  ``quality_imgsz_probe.py`` (``imgsz`` 320 beside the shared 640 study):
  every configuration's joined rows (``rows_for`` absolute, guarded and
  relative, ``rows_for_tta`` averaged and flipped) equal to JAX's, row by
  row: the counts exactly and so the percentages made from them; the JSON
  payloads and the printed lines equal but for the timings;
* ``select_threshold`` and ``cv_aggregate`` exactly JAX's on hand-built
  rows (ties, the guarded rule's fallback, mixed-grid keys) and on seeded
  ones, under all three rules.

The JAX scripts are loaded with ``importlib``; each side's
``prepare_study`` returns the study shared by the module (one per
``imgsz``), since JAX jits a new forward per study and a new decode per
``rows_for`` call: the JAX programs are most of this file's time.
"""

import dataclasses
import importlib.util
import json
import os
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu import config as jconfig
from lidar_object_detection_tpu.utils import cache as jcache
from lidar_object_detection_tpu_torch import config as tconfig
from lidar_object_detection_tpu_torch.models.yolo.serving import (
    load_serving_checkpoint)
from lidar_object_detection_tpu_torch.pipelines import quality
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
CKPT = "checkpoints/yolo11n_seg_distill.msgpack"
SHAPES = dict(max_points=8192, max_detections=32, max_boxes=48,
              image_height=376, image_width=1408)
# the raw outputs of the two float32 networks
RAW_ATOL = 1e-3
TIMINGS = ("sweep_s", "config_s", "forward_s")


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
    """Both packages' per-version configs at SHAPES, the JAX scripts'
    ``quality_common`` importable, and no compilation cache."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jconfig, tconfig):
            orig = mod.FusionConfig.for_version
            shapes = mod.ShapeConfig(**SHAPES)
            mp.setattr(mod.FusionConfig, "for_version", staticmethod(
                lambda v, orig=orig, shapes=shapes: dataclasses.replace(
                    orig(v), shapes=shapes)))
        mp.setattr(jcache, "enable_compilation_cache", lambda: None)
        mp.syspath_prepend(EXAMPLES)
        yield mp


@pytest.fixture(scope="module")
def tree(tmp_path_factory, pinned):
    real = [read_png_rgb(path) for path in chip_smoke.FRAMES]
    images = np.ascontiguousarray(np.stack([real[0], real[1],
                                            real[0][:, ::-1]]))
    det, _, _ = load_serving_checkpoint(CKPT, device="cpu")
    first = det.detect(images)
    rng = np.random.default_rng(0)
    scenes = [chip_smoke.make_scene(
        rng, first["boxes"][b].numpy(), first["det_valid"][b].numpy(),
        num_points=SHAPES["max_points"], num_boxes=SHAPES["max_boxes"],
        num_valid=40) for b in range(len(images))]
    root = str(tmp_path_factory.mktemp("quality_tree"))
    return chip_smoke.quality_tree(root, images, scenes)


@pytest.fixture(scope="module")
def studies(tree):
    """{package: {imgsz: study}}, 640 made here, others on demand."""
    import quality_common as jq

    made = {"jax": {640: jq.prepare_study(CKPT, tree)},
            "port": {640: quality.prepare_study(CKPT, tree, "cpu")}}

    def get(package, imgsz):
        if imgsz not in made[package]:
            made[package][imgsz] = (
                jq.prepare_study(CKPT, tree, imgsz=imgsz)
                if package == "jax" else
                quality.prepare_study(CKPT, tree, "cpu", imgsz=imgsz))
        return made[package][imgsz]
    return get


def _leaves(out):
    return [np.asarray(x) for v in out.values()
            for x in (v if isinstance(v, list) else [v])]


def test_prepare_study_matches_jax(studies):
    """One forward over the tree's 3 frames: the same letterbox, scale
    and frame count, raw outputs within RAW_ATOL."""
    jctx, tctx = studies("jax", 640), studies("port", 640)
    assert (tctx.scale, tctx.n_frames) == (jctx.scale, jctx.n_frames) \
        == ("n", 3)
    assert (tctx.spec.dst_h, tctx.spec.dst_w) == (jctx.spec.dst_h,
                                                  jctx.spec.dst_w)
    assert sorted(tctx.raw_out) == sorted(jctx.raw_out)
    for a, b in zip(_leaves(jctx.raw_out), _leaves(tctx.raw_out)):
        np.testing.assert_allclose(b, a, rtol=0, atol=RAW_ATOL)
    np.testing.assert_array_equal(tctx.images, jctx.images)


class Recorder:
    """Wraps a module's ``rows_for`` / ``rows_for_tta`` to keep the rows
    each call returns, as dicts, with the call's arguments."""

    def __init__(self, mp, module):
        self.calls = []
        for name in ("rows_for", "rows_for_tta"):
            real = getattr(module, name)
            mp.setattr(module, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def wrapped(ctx, *args, **kwargs):
            rows = real(ctx, *args, **kwargs)
            self.calls.append((name, args, kwargs,
                               [vars(r) for r in rows]))
            return rows
        return wrapped


def _strip(payload):
    """A payload without its timings."""
    if isinstance(payload, dict):
        return {k: _strip(v) for k, v in payload.items()
                if k not in TIMINGS}
    if isinstance(payload, list):
        return [_strip(v) for v in payload]
    return payload


def _lines(text, out):
    """Printed lines without the timings and with the output path
    named <out>."""
    text = text.replace(out, "<out>")
    text = re.sub(r"mirrored forward: [0-9.]+s", "<t>", text)
    return re.sub(r'"(sweep_s|config_s|forward_s)": [0-9.]+', "<t>", text)


def _run_both(monkeypatch, capsys, studies, tree, tmp_path, script, cmd,
              flags):
    """The JAX script and the port's subcommand on the tree, each with
    its module's shared studies; returns {package: (payload, lines,
    recorded calls)}."""
    import quality_common as jq

    out = {}
    capsys.readouterr()
    for package in ("jax", "port"):
        path = str(tmp_path / f"{package}.json")
        study = lambda ckpt, dataset, *a, package=package, **kw: studies(
            package, kw.get("imgsz", 640))
        if package == "jax":
            monkeypatch.setattr(jq, "prepare_study", study)
            rec = Recorder(monkeypatch, jq)
            example = _load_example(script)
            monkeypatch.setattr(sys, "argv", ["x", "--dataset", tree,
                                              "--out", path, *flags])
            example.main()
        else:
            monkeypatch.setattr(quality, "prepare_study", study)
            rec = Recorder(monkeypatch, quality)
            assert quality.main([cmd, "--dataset", tree, "--out", path,
                                 "--device", "cpu", *flags]) == 0
        with open(path) as f:
            payload = json.load(f)
        out[package] = (payload, _lines(capsys.readouterr().out, path),
                        rec.calls)
    return out


def _assert_same(out, n_calls):
    (jp, jl, jc), (tp, tl, tc) = out["jax"], out["port"]
    assert len(tc) == len(jc) == n_calls
    for (jn, ja, jk, jr), (tn, ta, tk, tr) in zip(jc, tc):
        assert (tn, ta, tk) == (jn, ja, jk)
        assert tr == jr, (tn, ta, tk)
    assert _strip(tp) == _strip(jp)
    assert tl == jl
    return tp


def test_knob_sweep_matches_jax(monkeypatch, capsys, studies, tree,
                                tmp_path):
    """Absolute and relative cuts and a guarded point (the hflip-TTA
    point's rows are the flip probe's ``averaged``): JAX's rows, payload
    and lines."""
    out = _run_both(monkeypatch, capsys, studies, tree, tmp_path,
                    "quality_knob_sweep", "knob-sweep",
                    ["--mask-thr", "0.5", "--thr-mode", "absolute",
                     "relative", "--guarded-grid", "0.99:0.5:200"])
    payload = _assert_same(out, 3)
    modes = [(r.get("thr_mode"), r.get("tta")) for r in payload["results"]]
    assert sorted(map(str, modes)) == sorted(map(str, [
        ("absolute", None), ("relative", None), (None, "none")]))
    assert min(r["matched_cars"] for r in payload["results"]) >= 5


def test_flip_probe_matches_jax(monkeypatch, capsys, studies, tree,
                                tmp_path):
    """The committed guarded point single view, from the mirrored view
    alone (``mode="flipped"``) and averaged."""
    out = _run_both(monkeypatch, capsys, studies, tree, tmp_path,
                    "quality_flip_probe", "flip-probe",
                    ["--ckpt", CKPT, "--configs", "0.99:0.5:200"])
    payload = _assert_same(out, 3)
    assert [r["mode"] for r in payload["results"]] == [
        "baseline", "flipped", "averaged"]
    assert all(r["matched_cars"] > 0 for r in payload["results"])


def test_threshold_cv_matches_jax(monkeypatch, capsys, studies, tree,
                                  tmp_path):
    """Leave-one-frame-out over a plain grid: the guarded and argmax
    rules' picks per fold and held-out aggregates."""
    out = _run_both(monkeypatch, capsys, studies, tree, tmp_path,
                    "quality_threshold_cv", "threshold-cv",
                    ["--mask-thr", "0.5", "0.99"])
    payload = _assert_same(out, 2)
    assert [r["rule"] for r in payload["cv"]] == ["guarded", "argmax"]
    assert payload["n_frames"] == 3


def test_imgsz_probe_matches_jax(monkeypatch, capsys, studies, tree,
                                 tmp_path):
    """A study at imgsz 320 (letterbox 96 x 320, a 24 x 80 proto grid):
    its forward against JAX's within RAW_ATOL, then the probe's rows."""
    for a, b in zip(_leaves(studies("jax", 320).raw_out),
                    _leaves(studies("port", 320).raw_out)):
        np.testing.assert_allclose(b, a, rtol=0, atol=RAW_ATOL)
    assert studies("port", 320).spec.dst_w == 320
    out = _run_both(monkeypatch, capsys, studies, tree, tmp_path,
                    "quality_imgsz_probe", "imgsz-probe",
                    ["--ckpt", CKPT, "--imgsz", "320", "--mask-thr",
                     "0.5", "--guarded"])
    payload = _assert_same(out, 1)
    assert payload["results"][0]["imgsz"] == 320


# ---------------------------------------------------------------------------
# the threshold selection, host NumPy
# ---------------------------------------------------------------------------

def _rows(*triples):
    """(frame, eroded %, count) -> that many rows, diffs varying."""
    out = []
    for frame, pct, count in triples:
        out.extend(SimpleNamespace(frame=frame, inside_pct_eroded=pct,
                                   inside_pct_raw=pct - 5.0,
                                   inside_pct_diff=5.0 + 0.1 * i)
                   for i in range(count))
    return out


def _seeded(seed):
    rng = np.random.default_rng(seed)
    keys = [0.5, 0.9, "0.99+floor0.5@200", "tta:0.99+floor0.5@200"]
    rows = {k: _rows(*[(f, round(float(rng.uniform(40, 90)), 2),
                        int(rng.integers(1, 4))) for f in range(5)])
            for k in keys}
    return rows, keys, list(range(5))


HAND = {
    "crossing": ({0.5: _rows((1, 90.0, 2), (2, 10.0, 2)),
                  0.9: _rows((1, 20.0, 2), (2, 95.0, 2))}, [0.5, 0.9],
                 [1, 2]),
    "ties": ({0.5: _rows((1, 70.0, 2), (2, 70.0, 2)),
              0.9: _rows((1, 70.0, 2), (2, 70.0, 2))}, [0.9, 0.5], [1, 2]),
    "guard fallback": ({0.5: _rows((1, 70.0, 5), (3, 60.0, 1)),
                        0.9: _rows((2, 80.0, 1), (3, 99.0, 1))},
                       [0.5, 0.9], [1, 2, 3]),
    "coverage": ({0.5: _rows((1, 70.0, 3), (2, 70.0, 3)),
                  "0.99+floor0.5@200": _rows((1, 75.0, 3), (2, 74.0, 3)),
                  "0.99": _rows((1, 99.0, 1), (2, 99.0, 1))},
                 [0.5, "0.99", "0.99+floor0.5@200"], [1, 2]),
}


@pytest.mark.parametrize("rule", ["argmax", "guarded", "coverage"])
def test_threshold_selection_is_jax(rule):
    """``select_threshold`` and ``cv_aggregate`` give the JAX script's
    picks and aggregates exactly, on the hand-built cases and on three
    seeded mixed grids (the guarded rule on float grids only, as in
    JAX)."""
    example = _load_example("quality_threshold_cv")
    cases = dict(HAND)
    cases.update({f"seed {s}": _seeded(s) for s in range(3)})
    compared = 0
    for name, (rows, keys, frames) in cases.items():
        if rule == "guarded" and not all(isinstance(k, float)
                                         for k in keys):
            continue
        for guard in (0, 2):
            for train in ([f for f in frames if f != frames[0]], frames):
                assert quality.select_threshold(
                    rows, keys, set(train), rule, guard) == \
                    example.select_threshold(rows, keys, set(train), rule,
                                             guard), (name, train)
            got = quality.cv_aggregate(rows, keys, frames, rule, guard)
            ref = example.cv_aggregate(rows, keys, frames, rule, guard)
            assert json.dumps(got) == json.dumps(ref), name
            compared += 1
    assert compared >= (6 if rule == "guarded" else 14)
