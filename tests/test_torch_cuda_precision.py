"""The float32 detector pins its own precision on the card.

PyTorch lets cuDNN run float32 convolutions in TF32 by default, which
keeps about three decimal digits.  The CLI serves the checkpoint in
float32, as the JAX package does, so ``YoloDetector`` runs its float32
forward in full float32 and restores the caller's settings after it.
The first test holds the CLI's detector's raw float32 outputs, with the
process's settings untouched, bit-equal to the same forward with TF32
switched off for the whole process; it shows that every convolution runs
inside the pin, and that the same forward without the pin differs, so
that the comparison does see TF32.  The second runs ``csv_eval`` with the
process's settings untouched: its master CSV must be byte-equal to the
same run with TF32 off.  The CSV holds integer counts and rounded
percentages, so only the first test tells a TF32 forward apart.

The test is marked ``cuda`` and skips without a card.  It imports nothing
of JAX, Flax or the JAX package, so that it collects on the card's
machine:

    python -m pytest tests/test_torch_cuda_precision.py -m cuda
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


def _precision():
    return (torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cuda.matmul.fp32_precision)


def _cli_detector(dev):
    """The detector as the CLI builds it for --weights: float32,
    unfolded."""
    from lidar_object_detection_tpu_torch.models.yolo.serving import (
        load_serving_checkpoint)

    det, _, _ = load_serving_checkpoint(chip_smoke.CKPT, (chip_smoke.H0,
                                                          chip_smoke.W0),
                                        default_scale="x", device=dev)
    assert det.dtype == torch.float32
    return det


def _flat(outputs):
    """The network's raw outputs (a dict of tensors or lists of them) as
    one list, in a fixed order."""
    flat = []
    for key in sorted(outputs):
        value = outputs[key]
        flat += list(value) if isinstance(value, (list, tuple)) else [value]
    return flat


@contextlib.contextmanager
def _tf32_off_globally():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_float32_forward_is_bit_equal_to_a_tf32_off_run(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the precision pin acts on cuDNN")
    from lidar_object_detection_tpu_torch.models.yolo import detector
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    dev = torch.device("cuda")
    # the process's defaults: TF32 allowed for cuDNN convolutions
    assert torch.backends.cudnn.allow_tf32
    before = _precision()
    det = _cli_detector(dev)
    images = np.stack([read_png_rgb(p) for p in chip_smoke.FRAMES])

    # the precision each convolution sees when it runs
    seen = []
    convs = [m for m in det.model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    hooks = [m.register_forward_pre_hook(
        lambda *_: seen.append(torch.backends.cudnn.conv.fp32_precision))
        for m in convs]
    try:
        pinned = _flat(det.forward(images))
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    assert _precision() == before, "the detector left its precision set"
    # with hflip TTA each convolution runs once, on both views together
    assert len(seen) == len(convs) > 50
    assert set(seen) == {"ieee"}, set(seen)

    with _tf32_off_globally():
        off = _flat(det.forward(images))
    assert len(pinned) == len(off)
    for a, b in zip(pinned, off):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)

    # the same forward without the pin runs TF32 and differs: the
    # comparison above would see a forward that lost the pin
    monkeypatch.setattr(detector, "full_float32", contextlib.nullcontext)
    unpinned = _flat(det.forward(images))
    assert not all(torch.equal(a, b) for a, b in zip(unpinned, off))


def test_float32_csv_eval_needs_no_global_tf32_switch(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the precision pin acts on cuDNN")
    from lidar_object_detection_tpu_torch.pipelines.runner import csv_eval
    from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

    dev = torch.device("cuda")
    # the process's defaults: TF32 allowed for cuDNN convolutions
    assert torch.backends.cudnn.allow_tf32
    before = _precision()
    det = _cli_detector(dev)
    images = np.stack([read_png_rgb(p) for p in chip_smoke.FRAMES])
    first = det.detect(images)
    rng = np.random.default_rng(5)
    frames = []
    for b, path in enumerate(chip_smoke.FRAMES):
        points, pvalid, corners, bvalid = chip_smoke.make_scene(
            rng, first["boxes"][b].cpu().numpy(),
            first["det_valid"][b].cpu().numpy())
        frames.append((100 + b, path, points[pvalid], corners[bvalid]))
    root = str(tmp_path / "kitti360")
    chip_smoke.write_kitti360_tree(root, frames)

    pinned = os.path.join(str(tmp_path), "pinned.csv")
    csv_eval(root, pinned, detector=det, device=dev, timestamp="t")
    assert _precision() == before, "the detector left its precision set"

    off = os.path.join(str(tmp_path), "tf32_off.csv")
    with _tf32_off_globally():
        csv_eval(root, off, detector=det, device=dev, timestamp="t")
    with open(pinned, "rb") as a, open(off, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    assert len(got.splitlines()) > 2
