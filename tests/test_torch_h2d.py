"""The uploader of ``utils/h2d.py`` on the CPU: its ring and worker stage
through plain host memory when the device is not a card (the card's
side, pinned slots, the side stream and events, is held to ``.to()`` in
``tests/test_torch_cuda_h2d.py``).  Small slots, so that the arrays span
several slots and end inside one.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from lidar_object_detection_tpu_torch.utils import h2d, profiling

SLOT = 64
SIZES = [0, 1, SLOT - 1, SLOT, SLOT + 1, 3 * SLOT + 5, 1000]


@pytest.fixture
def up():
    u = h2d.Uploader("cpu", slot_bytes=SLOT, slots=3)
    yield u
    u.close()
    assert not u._worker.is_alive()


@pytest.fixture
def tracer():
    t = profiling.enable_tracer()
    yield t
    profiling.disable_tracer()


def _array(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if dtype == np.uint8:
        return rng.integers(0, 256, n, dtype=np.uint8)
    return rng.standard_normal(n).astype(dtype)


def _equal(a: np.ndarray, t: torch.Tensor) -> bool:
    """Bit-equal, shape and dtype included."""
    b = t.numpy()
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.bool_])
@pytest.mark.parametrize("n", SIZES)
def test_arrays_come_through_bit_equal(up, dtype, n):
    src = _array(dtype, n, n)
    shaped = src.reshape(1, n) if n % 2 else src
    out, = up.submit([shaped]).result()
    assert _equal(shaped, out)


def test_a_job_of_many_arrays_and_tensors(up):
    arrays = [_array(np.float32, 333, 1).reshape(9, 37),
              _array(np.uint8, 200, 2), np.zeros((0, 4), np.float32),
              _array(np.bool_, 129, 3).reshape(3, 43)]
    tensors = [torch.arange(50, dtype=torch.int32)]
    outs = up.submit(arrays + tensors).result()
    for a, t in zip(arrays, outs):
        assert _equal(a, t)
    assert torch.equal(outs[-1], tensors[0])


def test_a_non_contiguous_source_takes_the_plain_copy(up, tracer):
    src = torch.arange(600, dtype=torch.float32).reshape(20, 30)[:, ::3]
    out, = up.submit([src]).result()
    assert torch.equal(out, src)
    assert [r.nbytes for r in tracer.take() if r.name == "h2d.stage"] == []


def test_two_jobs_in_a_row_return_their_own_bytes(up):
    """Same shape, other contents: nothing of the first job's slots or
    copies reaches the second."""
    first = _array(np.float32, 200, 10)
    second = _array(np.float32, 200, 11)
    a, = up.submit([first]).result()
    b, = up.submit([second]).result()
    assert _equal(first, a) and _equal(second, b)
    again = first.copy()
    c, = up.submit([again]).result()
    again[:] = 0
    assert _equal(first, c)


def test_a_job_sent_ahead_waits_for_the_next_and_goes_behind_it(up, tracer):
    ahead_src = _array(np.uint8, 5 * SLOT, 20)
    frames_src = _array(np.uint8, 2 * SLOT + 3, 21)
    ahead = up.submit([ahead_src], after_next=True)
    assert not ahead._job.done.wait(0.2)        # parked: nothing ran
    frames = up.submit([frames_src])
    f, = frames.result()
    a, = ahead.result()
    assert _equal(frames_src, f) and _equal(ahead_src, a)
    stages = [r for r in tracer.take() if r.name == "h2d.stage"]
    assert [r.nbytes for r in stages] == [frames_src.nbytes,
                                          ahead_src.nbytes]
    assert stages[0].end_ns <= stages[1].start_ns
    assert all(r.parent is None for r in stages)


def test_a_job_sent_ahead_runs_on_release_or_result(up):
    src = _array(np.float32, 100, 30)
    released = up.submit([src], after_next=True)
    released.release()
    assert released._job.done.wait(10)
    taken = up.submit([src], after_next=True)
    out, = taken.result()                      # no next job: no deadlock
    assert _equal(src, out) and _equal(src, released.result()[0])


def test_close_serves_a_parked_job():
    u = h2d.Uploader("cpu", slot_bytes=SLOT, slots=2)
    src = _array(np.uint8, 300, 40)
    handle = u.submit([src], after_next=True)
    u.close()
    assert not u._worker.is_alive()
    assert _equal(src, handle.result()[0])
    with pytest.raises(RuntimeError, match="closed"):
        u.submit([src])


def test_an_error_in_the_worker_reaches_result(up, monkeypatch):
    def broken(*args):
        raise ValueError("staging failed")

    monkeypatch.setattr(up, "_stage", broken)
    handle = up.submit([_array(np.uint8, 10, 50)])
    with pytest.raises(ValueError, match="staging failed"):
        handle.result()
    monkeypatch.undo()
    src = _array(np.uint8, 10, 51)
    assert _equal(src, up.submit([src]).result()[0])   # the worker lives


def test_a_handle_is_taken_once(up):
    handle = up.submit([_array(np.uint8, 10, 60)])
    handle.result()
    with pytest.raises(RuntimeError, match="already taken"):
        handle.result()


def test_jobs_from_many_threads_keep_their_bytes(up):
    """More submitting threads than cores, a short switch interval: each
    job's outputs are its own sources' bytes."""
    bad, done = [], []
    interval = sys.getswitchinterval()

    def client(k):
        for j in range(15):
            srcs = [_array(np.float32, 37 + k + j, 1000 * k + j),
                    _array(np.uint8, 3 * SLOT + k, 1000 * k + j + 500)]
            outs = up.submit(srcs, after_next=(j % 3 == 0)).result()
            if not all(_equal(a, t) for a, t in zip(srcs, outs)):
                bad.append((k, j))
        done.append(k)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(12)) and bad == []


def _no_uploader(device):
    raise AssertionError("an uploader was asked for off the card")


def test_upload_off_the_card_is_a_plain_copy(monkeypatch):
    monkeypatch.setattr(h2d, "uploader", _no_uploader)
    src = _array(np.float32, 64, 70).reshape(8, 8)
    out, = h2d.upload([src], "cpu")
    assert _equal(src, out)
