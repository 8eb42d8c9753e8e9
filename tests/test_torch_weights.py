"""Checkpoint reading, weight conversion and the YOLO11-seg forward of the
port against Flax.

The port reads the flax msgpack checkpoint without ``msgpack`` or flax;
its arrays must be bit-equal to ``flax.serialization.msgpack_restore``.
The converted weights in the PyTorch network must reproduce
``Yolo11.apply`` in float32 to rtol = atol = 1e-4: the convolutions sum in
another order (measured difference about 4e-5 on outputs of magnitude up
to 30), and TF32 is switched off so that no convolution rounds its inputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from lidar_object_detection_tpu.models.yolo.model import (
    Yolo11 as JYolo11, YoloConfig as JYoloConfig)
from lidar_object_detection_tpu.models.yolo.weights import (
    fold_serving_variables as jfold)
from lidar_object_detection_tpu_torch.models.yolo.model import (
    Yolo11, YoloConfig)
from lidar_object_detection_tpu_torch.models.yolo.weights import (
    fold_serving_variables, from_flax_variables)
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack, unpackb)

CKPT = "checkpoints/yolo11n_seg_distill.msgpack"


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_reader_bit_equal_to_flax():
    with open(CKPT, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    got = read_flax_msgpack(CKPT)
    ref_leaves = dict(_leaves(ref))
    got_leaves = dict(_leaves(got))
    assert ref_leaves.keys() == got_leaves.keys()
    assert len(got_leaves) == 471      # 470 arrays + step
    for key, want in ref_leaves.items():
        have = got_leaves[key]
        want = np.asarray(want)
        assert have.dtype == want.dtype and have.shape == want.shape, key
        assert have.tobytes() == want.tobytes(), key


def test_reader_scalars_and_bfloat16():
    """msgpack scalars of every width and a bfloat16 ndarray extension,
    written out by hand."""
    import struct

    bf16 = torch.tensor([1.5, -2.0, 0.15625], dtype=torch.bfloat16)
    raw = bf16.view(torch.int16).numpy().tobytes()
    payload = (b"\x93" + b"\x91\x03" + b"\xa8bfloat16"
               + b"\xc4" + bytes([len(raw)]) + raw)
    doc = (b"\x87"
           + b"\xa1a" + b"\xcd" + struct.pack(">H", 700)
           + b"\xa1b" + b"\xd2" + struct.pack(">i", -70000)
           + b"\xa1c" + b"\xcb" + struct.pack(">d", 0.25)
           + b"\xa1d" + b"\x92\xc0\xc3"
           + b"\xa1e" + b"\xf6"
           + b"\xa1f" + b"\xd9\x03abc"
           + b"\xa1g" + b"\xc7" + bytes([len(payload)]) + b"\x01" + payload)
    out = unpackb(doc)
    assert out["a"] == 700 and out["b"] == -70000 and out["c"] == 0.25
    assert out["d"] == [None, True] and out["e"] == -10 and out["f"] == "abc"
    assert out["g"].dtype == torch.bfloat16
    assert torch.equal(out["g"], bf16)
    with pytest.raises(ValueError):
        unpackb(doc + b"\x00")


@pytest.fixture
def no_tf32():
    """TF32 off for convolutions and products during one test; the
    process's settings are restored after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.parametrize("fold", [False, True])
def test_forward_matches_flax(fold, no_tf32):
    with open(CKPT, "rb") as f:
        variables = serialization.msgpack_restore(f.read())["variables"]
    tvars = read_flax_msgpack(CKPT)["variables"]
    if fold:
        variables = jfold(variables, dtype=jnp.float32)
        tvars = fold_serving_variables(tvars, dtype=torch.float32)
    x = np.random.default_rng(0).random((2, 64, 128, 3)).astype(np.float32)
    ref = JYolo11(JYoloConfig(scale="n")).apply(variables, jnp.asarray(x))
    model = Yolo11(YoloConfig(scale="n"))
    model.load_state_dict(from_flax_variables(tvars), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for key in ("box", "cls", "coef"):
        assert len(got[key]) == 3
        for a, b in zip(ref[key], got[key]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got["proto"].numpy(),
                               np.asarray(ref["proto"]), rtol=1e-4,
                               atol=1e-4)


def test_state_dict_keys_are_ultralytics():
    sd = from_flax_variables(read_flax_msgpack(CKPT)["variables"])
    assert "model.0.conv.weight" in sd
    assert sd["model.0.conv.weight"].shape == (16, 3, 3, 3)      # OIHW
    assert sd["model.23.proto.upsample.weight"].shape == (64, 64, 2, 2)
    assert "model.23.cv3.0.0.0.conv.weight" in sd
    assert "model.10.m.0.attn.qkv.bn.running_var" in sd
    assert "model.10.m.0.ffn.1.conv.weight" in sd
