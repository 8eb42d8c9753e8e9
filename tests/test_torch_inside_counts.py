"""Inside-count (kernel K1 of the port) against the JAX Pallas kernel.

The plain PyTorch twin must equal ``pallas_inside_counts_packed`` run in
interpret mode, bit for bit: both count 0/1 hits exactly.  The CUDA
kernel itself runs only on a card (``-m cuda``); here its wrapper must
refuse CPU tensors rather than fall back.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_object_detection_tpu.ops.pallas_count import (
    pallas_inside_counts_packed)
from lidar_object_detection_tpu_torch.ops import inside_counts as ic
from tests.test_boxes import make_box


def _case(rng, p=2048, g=24, d=5):
    points = rng.uniform(-12, 12, (p, 3)).astype(np.float32)
    corners = np.stack([make_box(rng.uniform(-8, 8, 3), (3, 5.5, 2.5),
                                 rng.uniform(-3, 3))
                        for _ in range(g)]).astype(np.float32)
    # put a third of the points inside boxes so that counts are not tiny
    for i in range(0, p, 3):
        c = corners[rng.integers(g)]
        t = rng.uniform(0.05, 0.95, 3)
        points[i] = c[0] + t[0] * (c[1] - c[0]) + t[1] * (c[3] - c[0]) \
            + t[2] * (c[4] - c[0])
    box_mask = rng.random(g) > 0.3
    corners[~box_mask & (rng.random(g) > 0.5)] = 0.0  # degenerate padding
    words = rng.integers(0, 2 ** d, p).astype(np.uint32)
    words[rng.random(p) > 0.7] = 0
    return points, words, corners, box_mask


@pytest.mark.parametrize("d", [1, 5, 32])
def test_twin_matches_pallas_kernel(rng, d):
    points, words, corners, box_mask = _case(rng, d=d)
    if d == 32:
        words = rng.integers(0, 2 ** 32, len(words), dtype=np.uint64
                             ).astype(np.uint32)
    ref_c, ref_t = pallas_inside_counts_packed(
        jnp.asarray(points), jnp.asarray(words), jnp.asarray(corners),
        jnp.asarray(box_mask), num_det=d, tile=512, interpret=True)
    got_c, got_t = ic.inside_counts(
        torch.from_numpy(points), torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(corners), torch.from_numpy(box_mask), d,
        chunk=700)
    assert got_c.dtype == torch.int32 and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    assert np.asarray(ref_c).sum() > 0
    # invalid boxes never hold a point
    assert not got_c.numpy()[:, ~box_mask].any()


@pytest.mark.parametrize("d", [5, 32])
def test_batched_twin_matches_pallas_frame_by_frame(rng, d):
    """The twin over a batch of 3 frames, in one call, equals the Pallas
    kernel run frame by frame in interpret mode."""
    frames = [_case(rng, p=1536, d=d) for _ in range(3)]
    if d == 32:
        frames = [(pt, rng.integers(0, 2 ** 32, len(w), dtype=np.uint64)
                   .astype(np.uint32), c, m) for pt, w, c, m in frames]
    stack = lambda i: np.stack([f[i] for f in frames])
    got_c, got_t = ic.inside_counts(
        torch.from_numpy(stack(0)),
        torch.from_numpy(stack(1).view(np.int32)),
        torch.from_numpy(stack(2)), torch.from_numpy(stack(3)), d,
        chunk=500)
    assert got_c.shape == (3, d, 24) and got_t.shape == (3, d)
    for b, (points, words, corners, box_mask) in enumerate(frames):
        ref_c, ref_t = pallas_inside_counts_packed(
            jnp.asarray(points), jnp.asarray(words), jnp.asarray(corners),
            jnp.asarray(box_mask), num_det=d, tile=512, interpret=True)
        np.testing.assert_array_equal(got_c[b].numpy(), np.asarray(ref_c))
        np.testing.assert_array_equal(got_t[b].numpy(), np.asarray(ref_t))
    assert got_c.sum() > 0


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    points, words, corners, box_mask = _case(rng)
    args = (torch.from_numpy(points), torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(corners), torch.from_numpy(box_mask))
    with pytest.raises(ValueError, match="CUDA"):
        ic.inside_counts_cuda(*args, 5)
    with pytest.raises(ValueError, match="CUDA"):
        ic.inside_counts_cuda(*(a[None] for a in args), 5)


@pytest.mark.cuda
def test_batched_kernel_matches_twin_on_card(rng):
    """One launch for 3 frames of 20000 points (not a multiple of the
    kernel's 256-point rounds), equal to the twin frame by frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    frames = [_case(rng, p=20000, g=96, d=32) for _ in range(3)]
    dev = torch.device("cuda")
    stack = lambda i: torch.from_numpy(np.stack([f[i] for f in frames]))
    words = np.stack([f[1] for f in frames]).view(np.int32)
    args = (stack(0).to(dev), torch.from_numpy(words).to(dev),
            stack(2).to(dev), stack(3).to(dev), 32)
    got = ic.inside_counts_cuda(*args)
    ref = ic.inside_counts_plain(*args)
    for a, b in zip(got, ref):
        assert a.shape[0] == 3 and torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    points, words, corners, box_mask = _case(rng, p=65536, g=384, d=32)
    dev = torch.device("cuda")
    args = (torch.from_numpy(points).to(dev),
            torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(corners).to(dev),
            torch.from_numpy(box_mask).to(dev), 32)
    got = ic.inside_counts_cuda(*args)
    ref = ic.inside_counts_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
