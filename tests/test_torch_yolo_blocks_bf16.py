"""The port's bfloat16 YOLO11 blocks (``models/common.py``'s
compute-dtype layers, ``models/yolo/{blocks,model}.py``) against the JAX
package's Flax blocks with ``dtype=jnp.bfloat16``, on the same seeded
numpy inputs, and a bfloat16 ``YoloTrainer``'s checkpoint against the
JAX runner's bytes.

The JAX side is compiled with ``xla_allow_excess_precision`` off, so that
XLA keeps every bfloat16 rounding the Flax program states; by default
XLA on the CPU drops some of them (a convolution's output goes into the
next BatchNorm unrounded: the stem block's outputs were 0.742 bit-equal
that way, 0.99992 strictly).

Module level (train mode, float32 parameters, bfloat16 outputs): the
share of output elements bit-equal to Flax's and the largest deviation in
bfloat16 ulps of the reference element (``ulp_stats``), each pinned from
a measurement (``PINNED``); a head convolution with its bias fused into
the product (rounded once where Flax rounds twice) falls outside the
pinned figures.  The whole step is held in
``tests/test_torch_yolo_train_bf16.py``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from flax import serialization

import chip_smoke
from lidar_object_detection_tpu.models.yolo import blocks as jblocks
from lidar_object_detection_tpu_torch.models.common import (
    Conv2d, set_compute_dtype)
from lidar_object_detection_tpu_torch.models.yolo import blocks as tblocks
from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig
from lidar_object_detection_tpu_torch.models.yolo.weights import (
    from_flax_variables)
from lidar_object_detection_tpu_torch.parallel import optim as toptim
from lidar_object_detection_tpu_torch.parallel import train as ttrain
from lidar_object_detection_tpu_torch.pipelines import yolo_distill as tdist
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack)
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "yolo11n_seg_distill.msgpack")
H, W = 64, 128
B, T = 2, 6
SCHEDULE = (1e-3, 2e-3, 2, 10, 2e-5)
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two PyTorch threads for this file, the caller's count restored
    after it (six test workers share the machine's cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def jax_32_bit():
    """JAX in 32-bit mode, as its trainers run (the suite turns 64-bit
    mode on)."""
    with jax.enable_x64(False):
        yield


def strict(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with excess precision off: XLA
    keeps every rounding to bfloat16 the program states."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def ulp_stats(got, ref):
    """(share of elements bit-equal, largest deviation in bfloat16 ulps of
    the reference element) of two bfloat16 arrays (a torch tensor, a JAX
    or numpy array of the same layout).  An element's ulp is 2^(e - 7)
    for a reference of exponent e (the smallest normal's for 0)."""
    g = got.detach().float().numpy().astype(np.float64)
    r = np.asarray(ref).astype(np.float32).astype(np.float64)
    assert g.shape == r.shape
    mag = np.maximum(np.abs(r), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((g == r).mean()), float((np.abs(g - r) / ulp).max())


def as_jax_bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def nchw(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    return t if dtype is None else t.to(dtype)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def flax_pair(jmodule, tmodule, x):
    """A Flax module in train mode (strict compile) and the port's module
    set to bfloat16, from the same float32 variables (``bn_statistics``
    edits them first): returns (the port's module, the reference)."""
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodule.init)(jax.random.PRNGKey(0), x))
    bn_statistics(variables, np.random.default_rng(7))

    def apply(v, x):
        return jmodule.apply(v, x, train=True, mutable=["batch_stats"])[0]
    tmodule.load_state_dict(from_flax_variables(variables))
    set_compute_dtype(tmodule, BF16)
    return tmodule, np.asarray(strict(apply, variables, x))


def bn_statistics(variables, rng):
    """BatchNorm scales and running variances away from 1 and biases away
    from 0, so that the affine part of every normalization rounds."""
    def walk(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value)
            elif key in ("scale", "var"):
                tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(
                    np.float32)
            elif key == "bias":
                tree[key] = rng.normal(0.0, 0.3, value.shape).astype(
                    np.float32)
    for collection in variables.values():
        walk(collection)


def module_cases():
    """name -> (Flax module, the port's module, NHWC input, whether both
    take the input as bfloat16)."""
    rng = np.random.default_rng(0)
    x16 = rng.normal(0.3, 1.2, (2, 32, 32, 16)).astype(np.float32)
    x64 = rng.normal(0.0, 1.0, (2, 8, 16, 64)).astype(np.float32)
    x32 = rng.normal(0.0, 1.0, (2, 8, 16, 32)).astype(np.float32)
    return {
        # the stem: float32 images cast by the convolution
        "ConvBNAct": (jblocks.ConvBNAct(24, 3, 2, dtype=jnp.bfloat16),
                      tblocks.ConvBNAct(16, 24, 3, 2), x16, False),
        "Attention": (jblocks.Attention(64, 1, dtype=jnp.bfloat16),
                      tblocks.Attention(64, 1), x64, True),
        "Proto": (jblocks.Proto(32, 8, dtype=jnp.bfloat16),
                  tblocks.Proto(32, 32, 8), x32, True),
    }


# measured (CPU, strict compile): bit-equal share, largest ulps
PINNED = {"ConvBNAct": (0.999, 2), "Attention": (0.99, 128),
          "Proto": (0.965, 64), "head_conv": (1.0, 0)}


@pytest.mark.parametrize("name", ["ConvBNAct", "Attention", "Proto"])
def test_block_rounds_as_flax(name):
    """A YOLO block in bfloat16 train mode against the Flax block with
    ``dtype=bfloat16``: the share of output elements bit-equal and the
    largest deviation in ulps within PINNED (ConvBNAct: the stem's
    strided 3 x 3 convolution on float32 input, BatchNorm in float32,
    SiLU as XLA's ``x * (1 / (1 + exp(-x)))``; Attention: qkv, scores
    summed in float32, softmax in float32, ``attn @ v`` in bfloat16,
    the positional convolution and the projection; Proto: the
    upsample's product, then its bias)."""
    jm, tm, x, bf16_in = module_cases()[name]
    jx = as_jax_bf16(x) if bf16_in else jnp.asarray(x)
    tm, ref = flax_pair(jm, tm, jx)
    got = nhwc(tm.train()(nchw(x, BF16 if bf16_in else torch.float32)))
    assert got.dtype == BF16 and ref.dtype == jnp.bfloat16
    share, ulps = ulp_stats(got, ref)
    print(f"{name}: {share:.5f} bit-equal, largest {ulps:.3g} ulps")
    assert share >= PINNED[name][0] and ulps <= PINNED[name][1], (
        share, ulps)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def head_conv_case():
    rng = np.random.default_rng(1)
    x = as_jax_bf16(rng.normal(0.0, 1.0, (2, 16, 16, 32)))
    jc = fnn.Conv(20, (1, 1), use_bias=True, dtype=jnp.bfloat16)
    variables = jax.tree_util.tree_map(
        np.asarray, jc.init(jax.random.PRNGKey(1), x))
    variables["params"]["bias"] = rng.normal(0.0, 1.0, 20).astype(
        np.float32)
    ref = np.asarray(strict(jc.apply, variables, x))
    tc = Conv2d(32, 20, 1)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(
            variables["params"]["kernel"]).permute(3, 2, 0, 1))
        tc.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
    tc.compute_dtype = BF16
    return tc, nchw(np.asarray(x.astype(jnp.float32)), BF16), ref


def test_head_conv_adds_its_bias_after_the_product():
    """A biased 1 x 1 head convolution (Flax's ``nn.Conv(use_bias=True,
    dtype=bfloat16)``: the product rounded to bfloat16, then the bias
    added in bfloat16) within PINNED; the same convolution with its bias
    fused into the product (one rounding) falls outside them: the test
    tells the right placement from the wrong one."""
    tc, xt, ref = head_conv_case()
    got = ulp_stats(nhwc(tc(xt)), ref)
    fused = ulp_stats(nhwc(torch.nn.functional.conv2d(
        xt, tc.weight.to(BF16), tc.bias.to(BF16))), ref)
    print(f"head conv: {got[0]:.5f} bit-equal, largest {got[1]:.3g} ulps; "
          f"bias fused: {fused[0]:.5f}, {fused[1]:.3g}")
    share, ulps = PINNED["head_conv"]
    assert got[0] >= share and got[1] <= ulps
    assert fused[0] < share or fused[1] > ulps


def test_float32_layers_are_the_plain_layers():
    """``set_compute_dtype(model, float32)`` leaves every layer's own
    call: the outputs are the plain ``nn.Conv2d``'s bits, bias fused."""
    tc, xt, _ = head_conv_case()
    set_compute_dtype(tc, torch.float32)
    assert tc.compute_dtype is None
    x = xt.float()
    assert torch.equal(tc(x), torch.nn.functional.conv2d(x, tc.weight,
                                                         tc.bias))


# ---------------------------------------------------------------------------
# one whole step from the committed n variables
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# a bfloat16 trainer's checkpoint
# ---------------------------------------------------------------------------

def crops(n=B):
    """(n, 64, 128, 3) float32 crops of the committed camera frame (the
    float32 tests' batch)."""
    frame = read_png_rgb(chip_smoke.FRAMES[0]).astype(np.float32) / 255
    return np.stack([frame[180 + 40 * i:180 + 40 * i + H,
                           500 + 150 * i:500 + 150 * i + W]
                     for i in range(n)]).astype(np.float32)


def targets_of(rng, b=B, t=T, h=H, w=W, valid_per_frame=4):
    """The float32 tests' targets: boxes of a few cells, COCO car-like
    classes, validity and {0, 1} masks at prototype resolution."""
    boxes = np.zeros((b, t, 4), np.float32)
    valid = np.zeros((b, t), bool)
    for i in range(b):
        for j in range(valid_per_frame):
            bw, bh = rng.uniform(10, 0.6 * w), rng.uniform(8, 0.7 * h)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes[i, j] = (x0, y0, x0 + bw, y0 + bh)
            valid[i, j] = True
    classes = rng.choice([2, 5, 7], (b, t)).astype(np.int32)
    masks = (rng.random((b, t, h // 4, w // 4)) > 0.4).astype(np.float32)
    return {"boxes": boxes, "classes": classes, "valid": valid,
            "masks": masks}


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "train_yolo_distill_example",
        os.path.join(REPO, "examples", "train_yolo_distill.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module



def test_bf16_checkpoint_bytes_match_jax(tmp_path):
    """A bfloat16 trainer's checkpoint after a step: ``save_ckpt`` of its
    ``variables()``, ``ema_variables()`` and ``opt_state_dict()`` writes
    the JAX runner's bytes for the same state (flax's ``from_state_dict``
    into ``optax.adamw``'s state reads the optimizer's tree), every leaf
    float32; and before any step its variables' bytes are the float32
    trainer's."""
    example = _jax_example()
    committed = read_flax_msgpack(CKPT)["variables"]
    tr = ttrain.YoloTrainer(
        YoloConfig(scale="n"), image_size=(H, W), max_targets=T,
        ema_decay=0.9,
        learning_rate=toptim.warmup_cosine_decay_schedule(*SCHEDULE),
        device="cpu", dtype=BF16)
    tr.load(committed)
    tr.train_step(crops(), targets_of(np.random.default_rng(4)))
    variables, ema = tr.variables(), tr.ema_variables()
    opt = tr.opt_state_dict()
    for tree in (variables, ema, opt):
        leaves = jax.tree_util.tree_leaves(tree)
        assert all(np.asarray(v).dtype == np.float32 for v in leaves
                   if np.asarray(v).dtype.kind == "f")
    ours = str(tmp_path / "port.msgpack")
    tdist.save_ckpt(ours, variables, opt, 1, ema_variables=ema)
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(*SCHEDULE),
                     weight_decay=5e-4)
    template = tx.init(jax.tree_util.tree_map(jnp.asarray,
                                              variables["params"]))
    theirs = str(tmp_path / "jax.msgpack")
    example.save_ckpt(theirs, variables,
                      serialization.from_state_dict(template, opt), 1,
                      ema_variables=ema)
    for suffix in ("", ".opt", ".json"):
        with open(ours + suffix, "rb") as a, open(theirs + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    fresh = {}
    for dtype in (torch.float32, BF16):
        t = ttrain.YoloTrainer(YoloConfig(scale="n"), image_size=(H, W),
                               max_targets=T, device="cpu", dtype=dtype)
        t.load(committed)
        path = str(tmp_path / f"fresh_{dtype}.msgpack")
        tdist.save_ckpt(path, t.variables(), t.opt_state_dict(), 0)
        fresh[dtype] = open(path, "rb").read()
    assert fresh[torch.float32] == fresh[BF16]
