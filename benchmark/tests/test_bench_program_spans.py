"""The readers of the program's spans (``harness/program.py`` and six
readers in ``benchmark/metrics``) on synthetic records, ranges and device
intervals with known values; each gives None where there is nothing to
read."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark.harness import program, spec

NEW = ("h2d_ms.serve", "h2d_gbps.serve", "preprocess_ms.serve",
       "network_ms.serve", "detect_idle_ms.serve", "fuse_idle_ms.serve")


def _rec(name, chunk, ms, nbytes=0):
    return {"name": name, "chunk": chunk, "nbytes": nbytes, "device_ms": ms}


RECORDS = [
    _rec("detect", 1, 20.0), _rec("detect.upload", 1, 2.0, 4_000_000),
    _rec("detect.preprocess", 1, 3.0), _rec("detect.network", 1, 10.0),
    _rec("kernel.nms", 1, None), _rec("fuse.upload", 1, 1.0, 2_000_000),
    _rec("detect", 2, 25.0), _rec("detect.upload", 2, 4.0, 4_000_000),
    _rec("detect.preprocess", 2, 5.0), _rec("detect.network", 2, 12.0),
    _rec("fuse.upload", 2, 1.0, 2_000_000),
]
# two profiled chunks, in microseconds: detect [0, 100) and [200, 300),
# fuse [100, 150); device busy 10-60 (two overlapping kernels), 90-120
# (across detect's end into fuse) and 250-400 (past detect's end)
PROFILED = {
    "ranges": [("lidar::detect", 0.0, 100.0), ("lidar::fuse", 100.0, 150.0),
               ("lidar::detect", 200.0, 300.0)],
    "device": [(10.0, 40.0), (30.0, 60.0), (90.0, 120.0), (250.0, 400.0)],
    "profiled_chunks": 2,
}
EXPECTED = {
    "h2d_ms.serve": (3.0 + 5.0) / 2,
    "h2d_gbps.serve": 12_000_000 / 8e-3 / 1e9,
    "preprocess_ms.serve": 4.0,
    "network_ms.serve": 11.0,
    # (100 - 50 - 10) + (100 - 50) us over 2 chunks
    "detect_idle_ms.serve": 90e-3 / 2,
    # 50 - 20 us over 2 chunks
    "fuse_idle_ms.serve": 30e-3 / 2,
}


def _ctx(**prog):
    return types.SimpleNamespace(program=prog)


@pytest.mark.parametrize("name", NEW)
def test_reader_value(name):
    ctx = _ctx(records=RECORDS, **PROFILED)
    assert spec.load_reader(name)(ctx) == pytest.approx(EXPECTED[name],
                                                        rel=1e-12)


# no program; no records; the CPU's records (no events); ranges but no
# profiled chunk
NOTHING = [types.SimpleNamespace(), _ctx(),
           _ctx(records=[dict(r, device_ms=None) for r in RECORDS]),
           _ctx(ranges=PROFILED["ranges"], device=PROFILED["device"],
                profiled_chunks=0)]


@pytest.mark.parametrize("case", range(len(NOTHING)))
@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing(name, case):
    assert spec.load_reader(name)(NOTHING[case]) is None


def test_idle_is_clipped_to_the_range():
    # one device interval covering the whole range: no idle time
    ctx = _ctx(ranges=[("lidar::fuse", 10.0, 20.0)],
               device=[(0.0, 100.0)], profiled_chunks=1)
    assert program.idle_ms_per_chunk(ctx, "fuse") == 0.0
    assert program.idle_ms_per_chunk(ctx, "detect") is None


def _event(name, device, start, end, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_context_splits_ranges_from_device_operations():
    events = [
        _event("lidar::detect", DeviceType.CPU, 0.0, 100.0, True),
        _event("aten::add", DeviceType.CPU, 5.0, 6.0),
        # the range's mirror on the device is no operation
        _event("lidar::detect", DeviceType.CUDA, 8.0, 90.0, True),
        _event("add_kernel", DeviceType.CUDA, 10.0, 20.0),
        _event("Memcpy HtoD (Pageable -> Device)", DeviceType.CUDA, 30.0,
               40.0),
    ]
    rec = types.SimpleNamespace(name="detect.upload", chunk=3, nbytes=8,
                                device_ms=1.5, parent="detect")
    ctx = program.context([rec], events, 1)
    assert ctx == {
        "records": [_rec("detect.upload", 3, 1.5, 8)],
        "ranges": [("lidar::detect", 0.0, 100.0)],
        "device": [(10.0, 20.0), (30.0, 40.0)], "profiled_chunks": 1}
    assert program.idle_ms_per_chunk(types.SimpleNamespace(program=ctx),
                                     "detect") == pytest.approx(0.08)
