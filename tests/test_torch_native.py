"""The port's native scan loader (``data/native.py`` over its own copy of
``csrc/lidar_loader.cpp``) against its NumPy twin and against the JAX
package's ``data/native.py``, on synthetic Velodyne scans written into a
temporary directory.

Tolerances:

* padded loads, and compacted loads on the scalar C++ path: equal bit for
  bit to the NumPy twin and to the JAX package;
* compacted loads on the AVX-512 path, and the JAX package's cull (a
  float32 matrix product): its predicate fuses multiply-adds, so a point
  may land on the other side of a widened bound, by design; every point
  on which two culls disagree lies within 1e-3 px (or 1e-4 m of depth) of
  a bound, and the kept points come in the scan's order;
* the cull is conservative: every point the device's exact validity test
  keeps is kept.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.data import native as jnative
from lidar_object_detection_tpu_torch.data import native
from lidar_object_detection_tpu_torch.geom.projection import (
    point_validity, project_velo_points)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 1408, 376
DEPTH = (0.0, 50.0)
BACKENDS = ("native", "numpy")


def _spec(max_out=16384):
    return native.CompactionSpec.build(
        chip_smoke.VELO_TO_RECT, chip_smoke.INTRINSICS, W, H, *DEPTH, max_out)


def _edge_points(rng, n=4000):
    """Points whose projection lies within a few float32 ulps of the
    widened bounds of ``_spec``: u or v at -(margin + 0.5) or at the far
    edge + margin - 0.5, or depth at the widened depth bounds."""
    k = chip_smoke.INTRINSICS.astype(np.float64)
    lo, hi_u, hi_v = -1.5, W - 0.5 + 1.0, H - 0.5 + 1.0
    z = rng.uniform(1, 49, n)
    u = rng.uniform(lo, hi_u, n)
    v = rng.uniform(lo, hi_v, n)
    side = rng.integers(0, 6, n)
    u = np.where(side == 0, lo, np.where(side == 1, hi_u, u))
    v = np.where(side == 2, lo, np.where(side == 3, hi_v, v))
    z = np.where(side == 4, DEPTH[1] + 1e-3, z)
    z = np.where(side == 5, DEPTH[0] + 1e-3 + rng.uniform(0, 1e-3, n), z)
    cam = np.stack([(u - k[0, 2]) * z / k[0, 0], (v - k[1, 2]) * z / k[1, 1],
                    z], 1)
    cam = cam * (1 + rng.integers(-4, 5, (n, 1)) * np.finfo(np.float32).eps)
    pts = np.zeros((n, 4), np.float32)
    pts[:, :3] = chip_smoke.to_velo(cam)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """name -> path: 360-degree sweeps with cars in front (the stream's
    scans), a scan with most points in front of the camera, one with
    points on the cull's bounds, an empty scan, one point, and a file
    that is not a whole number of points."""
    root = tmp_path_factory.mktemp("scans")
    rng = np.random.default_rng(0)
    dets = np.array([[100, 150, 300, 260], [600, 160, 760, 250]], np.float32)
    out = {}
    for i in range(4):
        pts, pvalid, _, _ = chip_smoke.make_scene(
            rng, dets, np.ones(2, bool), num_points=20000 + 997 * i,
            num_boxes=64, num_valid=40, surround=True)
        out[f"sweep{i}"] = pts[pvalid]
    pts, pvalid, _, _ = chip_smoke.make_scene(
        rng, dets, np.ones(2, bool), num_points=20000, num_boxes=64,
        num_valid=40)
    out["front"] = pts[pvalid]
    out["edges"] = np.concatenate([_edge_points(rng), out["sweep0"][:3000]])
    out["empty"] = np.zeros((0, 4), np.float32)
    out["one"] = out["sweep1"][:1]
    paths = {}
    for name, pts in out.items():
        paths[name] = str(root / f"{name}.bin")
        pts.astype(np.float32).tofile(paths[name])
    paths["ragged"] = str(root / "ragged.bin")
    with open(paths["ragged"], "wb") as f:
        f.write(b"\0" * 70)
    return paths


def _raw(path):
    return np.fromfile(path, np.float32).reshape(-1, 4)


def _band(pts, spec, tol_px=1e-3, tol_depth=1e-4):
    """Points within the tolerance of a widened bound (float64)."""
    p = pts[:, :3].astype(np.float64) @ spec.proj[:, :3].T.astype(
        np.float64) + spec.proj[:, 3]
    z = p[:, 2]
    u, v = p[:, 0] / np.abs(z), p[:, 1] / np.abs(z)
    lo = -(spec.margin + 0.5)
    near = lambda a, b, t: np.abs(a - b) <= t * np.maximum(1, np.abs(b))
    return (near(u, lo, tol_px) | near(u, spec.width - 0.5 + spec.margin,
                                       tol_px)
            | near(v, lo, tol_px) | near(v, spec.height - 0.5 + spec.margin,
                                         tol_px)
            | near(z, spec.depth_min - 1e-3, tol_depth)
            | near(z, spec.depth_max + 1e-3, tol_depth))


def _assert_same_cull(raw, got, want, spec):
    """Two compacted loads of ``raw`` keep the same points up to the
    margin band, each in the scan's order."""
    for pts, valid, n in (got, want):
        assert valid[:n].all() and not valid[n:].any()
        assert not pts[n:].any()
    kept = []
    for pts, _, n in (got, want):
        index = {p.tobytes(): i for i, p in enumerate(raw)}
        rows = [index[p.tobytes()] for p in pts[:n]]
        assert rows == sorted(rows)
        mask = np.zeros(len(raw), bool)
        mask[rows] = True
        kept.append(mask)
    differ = kept[0] != kept[1]
    assert not (differ & ~_band(raw, spec)).any()


# ---------------------------------------------------------------------------
# building the library
# ---------------------------------------------------------------------------

def test_library_is_built_from_the_port_copy():
    path = native.build()
    assert path == native.build()
    assert path.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT == (native.CSRC / "build")
    assert str(native.CSRC) == os.path.join(
        REPO, "lidar_object_detection_tpu_torch", "csrc")
    assert path.name == "liblidar_loader.so"
    assert path.parent.name == native.source_hash()
    assert native.library() is native.library()
    assert not list(path.parent.glob("*.tmp"))


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch,
                                                     scans):
    """A source that does not compile raises, names the compiler's error,
    leaves no library behind, and no load falls back to NumPy."""
    bad = tmp_path / "lidar_loader.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not list((tmp_path / "build").rglob("*.so*"))
    with pytest.raises(RuntimeError, match="lidar_loader.cpp"):
        native.load_scan_padded(scans["sweep0"], 32768)
    with pytest.raises(RuntimeError, match="lidar_loader.cpp"):
        list(native.ScanPrefetcher([scans["sweep0"]], 32768))


def test_unknown_backend_raises(scans):
    with pytest.raises(ValueError, match="backend"):
        native.load_scan_padded(scans["one"], 8, backend="python")


# ---------------------------------------------------------------------------
# single loads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sweep0", "sweep3", "edges", "empty",
                                  "one"])
def test_padded_load_matches_twin_and_jax(scans, name):
    raw = _raw(scans[name])
    cap = 32768
    got = native.load_scan_padded(scans[name], cap)
    twin = native.load_scan_padded(scans[name], cap, backend="numpy")
    ref = jnative.load_scan_padded(scans[name], cap)
    for a in (twin, ref):
        assert got[2] == a[2] == len(raw)
        np.testing.assert_array_equal(got[0], a[0])
        np.testing.assert_array_equal(got[1], a[1])
    assert got[0].shape == (cap, 4) and got[1].dtype == np.bool_
    np.testing.assert_array_equal(got[0][:len(raw)], raw)
    exact = native.load_scan_padded(scans[name], max(len(raw), 1))
    assert exact[2] == len(raw)


@pytest.mark.parametrize("name", ["sweep0", "sweep1", "edges", "empty"])
def test_compacted_load_matches_twin_and_jax(scans, name):
    """The default native path (AVX-512 where the CPU has it) against the
    twin and the JAX package, up to the margin band."""
    spec = _spec()
    raw = _raw(scans[name])
    got = native.load_scan_compacted(scans[name], spec)
    twin = native.load_scan_compacted(scans[name], spec, backend="numpy")
    ref = jnative.load_scan_compacted(scans[name], spec)
    assert got[0].shape == (spec.max_out, 4)
    _assert_same_cull(raw, got, twin, spec)
    _assert_same_cull(raw, got, ref, spec)
    if name.startswith("sweep"):
        share = got[2] / len(raw)
        assert 0.15 < share < 0.5, share


SCALAR = """
import json, sys
import numpy as np
from lidar_object_detection_tpu_torch.data import native
spec = native.CompactionSpec.build(*{args!r})
out = {{}}
for path in {paths!r}:
    pts, valid, n = native.load_scan_compacted(path, spec)
    np.save(path + ".scalar.npy", pts)
    out[path] = n
print(json.dumps(out))
"""


def test_scalar_compaction_equals_twin_bit_for_bit(scans):
    """The scalar C++ path (``LIDAR_LOADER_NO_AVX512``, read once per
    process, hence the subprocess) gives the twin's buffers bit for bit,
    margin band included; the edge scan puts points on every bound."""
    spec = _spec()
    names = ["sweep0", "sweep2", "edges"]
    args = ([list(r) for r in chip_smoke.VELO_TO_RECT.astype(float)],
            [list(r) for r in chip_smoke.INTRINSICS.astype(float)], W, H,
            *DEPTH, spec.max_out)
    code = SCALAR.format(args=args, paths=[scans[n] for n in names])
    env = dict(os.environ, LIDAR_LOADER_NO_AVX512="1", PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert run.returncode == 0, run.stderr
    import json

    counts = json.loads(run.stdout.strip().splitlines()[-1])
    for name in names:
        pts, _, n = native.load_scan_compacted(scans[name], spec,
                                               backend="numpy")
        assert counts[scans[name]] == n
        np.testing.assert_array_equal(np.load(scans[name] + ".scalar.npy"),
                                      pts)
    raw = _raw(scans["edges"])
    keep = spec.cull_mask(raw)
    band = _band(raw, spec)
    # the edge scan has points on both sides of the bounds
    assert (band & keep).sum() > 100 and (band & ~keep).sum() > 100


@pytest.mark.parametrize("name", ["sweep0", "edges"])
def test_cull_is_conservative(scans, name):
    """No point that the device's exact validity test keeps is culled,
    on either backend; the cull drops most of a 360-degree sweep."""
    spec = _spec()
    raw = _raw(scans[name])
    u, v, d = project_velo_points(torch.from_numpy(raw),
                                  torch.from_numpy(chip_smoke.VELO_TO_RECT),
                                  torch.from_numpy(chip_smoke.INTRINSICS))
    exact = point_validity(u, v, d, W, H, *DEPTH).numpy()
    assert exact.sum() > 1000
    for backend in BACKENDS:
        pts, _, n = native.load_scan_compacted(scans[name], spec,
                                               backend=backend)
        kept = {p.tobytes() for p in pts[:n]}
        assert all(p.tobytes() in kept for p in raw[exact])
    if name == "sweep0":
        assert n < 0.5 * len(raw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_overflow_missing_and_ragged_raise(scans, backend):
    spec = _spec(max_out=256)
    raw = _raw(scans["sweep0"])
    with pytest.raises(ValueError, match=f"more than {len(raw) - 1} points"):
        native.load_scan_padded(scans["sweep0"], len(raw) - 1, backend)
    with pytest.raises(ValueError, match="256 points after compaction"):
        native.load_scan_compacted(scans["sweep0"], spec, backend)
    with pytest.raises(FileNotFoundError):
        native.load_scan_padded(scans["sweep0"] + ".missing", 8, backend)
    with pytest.raises(FileNotFoundError):
        native.load_scan_compacted(scans["sweep0"] + ".missing", spec,
                                   backend)
    with pytest.raises(ValueError, match="16-byte points"):
        native.load_scan_padded(scans["ragged"], 64, backend)
    # the JAX package raises the same for the same files
    with pytest.raises(ValueError):
        jnative.load_scan_compacted(scans["sweep0"], spec)
    with pytest.raises(FileNotFoundError):
        jnative.load_scan_padded(scans["sweep0"] + ".missing", 8)


# ---------------------------------------------------------------------------
# the prefetcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("threads", [1, 3])
def test_prefetcher_matches_single_loads_and_jax(scans, compact, threads):
    names = ["sweep0", "sweep1", "edges", "sweep2", "empty", "sweep3"] * 2
    paths = [scans[n] for n in names]
    spec = _spec() if compact else None
    cap = 32768
    runs = {}
    for backend in BACKENDS:
        items = list(native.ScanPrefetcher(paths, cap, num_threads=threads,
                                           queue_depth=2, compaction=spec,
                                           backend=backend))
        order = [i for i, *_ in items]
        assert sorted(order) == list(range(len(paths)))
        if threads == 1 and backend == "native":
            assert order == list(range(len(paths)))
        runs[backend] = {i: rest for i, *rest in items}
    runs["jax"] = {i: rest for i, *rest in jnative.ScanPrefetcher(
        paths, cap, num_threads=threads, compaction=spec)}
    for i, path in enumerate(paths):
        single = (native.load_scan_compacted(path, spec) if compact
                  else native.load_scan_padded(path, cap))
        got = runs["native"][i]
        for a, b in zip(got, single):
            np.testing.assert_array_equal(a, b)
        assert got[0].shape == (spec.max_out if compact else cap, 4)
        for other in ("numpy", "jax"):
            if compact:
                _assert_same_cull(_raw(path), got, runs[other][i], spec)
            else:
                for a, b in zip(got, runs[other][i]):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("bad", ["missing", "ragged", "overflow"])
def test_prefetcher_raises_for_a_bad_scan(scans, backend, bad):
    """A scan that fails to load raises the single load's exception when
    its turn comes; the scans before it were delivered."""
    paths = [scans["sweep0"], scans["sweep1"]]
    spec = _spec(max_out=8192)
    counts = [native.load_scan_compacted(scans[n], _spec(), "numpy")[2]
              for n in ("sweep0", "sweep1", "front")]
    assert max(counts[:2]) <= 8192 < counts[2]
    paths.append({"missing": scans["sweep0"] + ".missing",
                  "ragged": scans["ragged"], "overflow": scans["front"]}[bad])
    error = FileNotFoundError if bad == "missing" else ValueError
    seen = []
    with pytest.raises(error):
        for idx, *_ in native.ScanPrefetcher(paths, 32768, num_threads=1,
                                             compaction=spec,
                                             backend=backend):
            seen.append(idx)
    if backend == "native":
        assert seen == [0, 1]


def test_abandoned_prefetcher_stops_its_threads(scans):
    """Closing the iterator after one scan, while the loader threads wait
    for queue space, joins them."""
    paths = [scans["sweep0"]] * 24
    it = iter(native.ScanPrefetcher(paths, 32768, num_threads=4,
                                    queue_depth=1))
    next(it)
    done = threading.Event()
    threading.Thread(target=lambda: (it.close(), done.set()),
                     daemon=True).start()
    assert done.wait(30), "the prefetcher did not stop"
