"""The port's bfloat16 mixed-precision YOLO11-seg training step
(``YoloTrainer(..., dtype=torch.bfloat16)``, ``parallel/train.py``)
against the JAX package's ``_train_step`` with ``Yolo11(cfg,
dtype=jnp.bfloat16)``, on the same seeded numpy inputs; the blocks are
held bit by bit in ``tests/test_torch_yolo_blocks_bf16.py``.

JAX's step is compiled with ``xla_allow_excess_precision`` off, so that
XLA keeps every bfloat16 rounding the Flax program states.  One whole
step from the committed n variables, the EMA and the warm-up schedule
on, on the (2, 64, 128) batch of ``tests/test_torch_yolo_train.py`` and
N_BATCHES - 1 more.  bfloat16 rounding moves the gradients far from
float32 in JAX itself, and TAL's top-k and the mask loss's instances
follow the rounded heads, so the port's bfloat16 step is held to JAX's
by its distance summed over the batches, in units of JAX's bfloat16
drift from the float32 step (the port's float32 step, held to JAX's
within 1e-4 by the float32 tests, stands in for JAX's): each loss part
and the median tensor's gradient deviation (relative to the tensor's
largest entry) within STEP_MULTIPLE of that drift; the port's own drift
between a third and three times JAX's; every variable, gradient, moment
and EMA entry float32 with JAX's tree, the heads bfloat16.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from lidar_object_detection_tpu.models.yolo.model import (
    Yolo11 as JYolo11, YoloConfig as JYoloConfig)
from lidar_object_detection_tpu.parallel import train as jtrain
from lidar_object_detection_tpu_torch.models.yolo.model import YoloConfig
from lidar_object_detection_tpu_torch.models.yolo.weights import (
    yolo_flax_from_state)
from lidar_object_detection_tpu_torch.parallel import optim as toptim
from lidar_object_detection_tpu_torch.parallel import train as ttrain
from lidar_object_detection_tpu_torch.utils.flax_msgpack import (
    read_flax_msgpack)
from lidar_object_detection_tpu_torch.utils.png import read_png_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "yolo11n_seg_distill.msgpack")
H, W = 64, 128
LEVELS = ((8, 16), (4, 8), (2, 4))
B, T = 2, 6
SCHEDULE = (1e-3, 2e-3, 2, 10, 2e-5)
BF16 = torch.bfloat16
PARTS = ("loss", "cls", "box", "dfl", "seg")
# the port's bfloat16 step against JAX's, in units of JAX's bfloat16
# drift from the float32 step (the card's bfloat16 step is held to the
# CPU's by the same multiple)
STEP_MULTIPLE = chip_smoke.BF16_STEP_MULTIPLE
# the step's batches (``batches``)
N_BATCHES = 4


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


# ---------------------------------------------------------------------------
# one whole step from the committed n variables
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


def _capture_grads():
    """An optax transformation that passes the gradients through and
    keeps them as its state, so that JAX's ``_train_step`` returns them."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_step(variables, images, tg, dtype):
    tr = ttrain.YoloTrainer(
        YoloConfig(scale="n"), image_size=(H, W), max_targets=T,
        ema_decay=0.9,
        learning_rate=toptim.warmup_cosine_decay_schedule(*SCHEDULE),
        device="cpu", dtype=dtype)
    tr.load(variables)
    timgs, ttg = tr.put(images, tg)
    heads, forward = {}, tr.forward
    tr.forward = lambda x: heads.setdefault("out", forward(x))
    loss, parts = tr.loss(timgs, ttg)
    grads = tr.gradients(loss)
    tr.update(grads)
    return {"trainer": tr, "heads": heads["out"],
            "parts": {"loss": float(loss.detach()),
                      **{k: float(v.detach()) for k, v in parts.items()}},
            "grads": flat(yolo_flax_from_state(grads)["params"])}


def batches():
    """The float32 tests' batch (``crops()``, targets of seed 11), then
    N_BATCHES - 1 more: crops of both committed frames at offsets drawn
    from the batch's seed, and targets of that seed."""
    frames = [read_png_rgb(p).astype(np.float32) / 255
              for p in chip_smoke.FRAMES]
    out = [(crops(), targets_of(np.random.default_rng(11)))]
    for seed in range(12, 11 + N_BATCHES):
        rng = np.random.default_rng(seed)
        images = []
        for frame in frames:
            y = int(rng.integers(120, frame.shape[0] - H - 60))
            x = int(rng.integers(0, frame.shape[1] - W))
            images.append(frame[y:y + H, x:x + W])
        out.append((np.stack(images).astype(np.float32), targets_of(rng)))
    return out


@pytest.fixture(scope="module")
def step_case():
    """On each of ``batches()``: JAX's bfloat16 ``_train_step`` (one
    strict compile, 32-bit mode) and the port's float32 and bfloat16
    steps, from the committed n variables, with the warm-up schedule and
    the EMA on.  The first batch's states are kept."""
    variables = read_flax_msgpack(CKPT)["variables"]
    before = {k: v.copy() for k, v in flat(variables).items()}
    jtx = optax.chain(_capture_grads(),
                      optax.adamw(optax.warmup_cosine_decay_schedule(
                          *SCHEDULE), weight_decay=5e-4))
    step = functools.partial(
        jtrain._train_step,
        model=JYolo11(JYoloConfig(scale="n"), dtype=jnp.bfloat16), tx=jtx,
        num_classes=80, level_shapes=LEVELS, seg_weight=1.0, ema_decay=0.9)
    runs, compiled = [], None
    for images, tg in batches():
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)
        state = jtrain.TrainState(
            variables=jvars, opt_state=jtx.init(jvars["params"]),
            step=jnp.zeros((), jnp.int32), ema_variables=jvars)
        args = (state, jnp.asarray(images),
                {k: jnp.asarray(v) for k, v in tg.items()})
        if compiled is None:
            compiled = jax.jit(step).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        jstate, jm = compiled(*args)
        jstate = jax.tree_util.tree_map(np.asarray, jstate)
        runs.append({"jstate": jstate,
                     "jparts": {k: float(v) for k, v in jm.items()
                                if k != "step"},
                     "jgrads": flat(jstate.opt_state[0]),
                     "f32": port_step(variables, images, tg, torch.float32),
                     "bf16": port_step(variables, images, tg, BF16)})
    # the trainers copied the caller's arrays: their steps left them alone
    assert all(np.array_equal(v, before[k])
               for k, v in flat(variables).items())
    return runs


def drifts(runs):
    """Summed over the batches: per loss part, (port bf16 - JAX bf16,
    JAX bf16 - port f32, port bf16 - port f32) in absolute value; and the
    same three of the median tensor's gradient deviation."""
    out = {}
    for key in PARTS:
        out[key] = np.sum([[abs(r["bf16"]["parts"][key] - r["jparts"][key]),
                            abs(r["jparts"][key] - r["f32"]["parts"][key]),
                            abs(r["bf16"]["parts"][key]
                                - r["f32"]["parts"][key])]
                           for r in runs], axis=0)
    med = lambda a, b: float(np.median(grad_deviations(a, b)))
    out["gradients"] = np.sum(
        [[med(r["bf16"]["grads"], r["jgrads"]),
          med(r["jgrads"], r["f32"]["grads"]),
          med(r["bf16"]["grads"], r["f32"]["grads"])] for r in runs],
        axis=0)
    return out


def grad_deviations(got, ref):
    """Each tensor's largest deviation relative to its largest entry in
    ``ref``, for the tensors whose largest entry is not 0."""
    out = []
    for key, r in ref.items():
        scale = float(np.abs(r).max())
        if scale > 0:
            out.append(float(np.abs(got[key].astype(np.float64)
                                    - r).max()) / scale)
    return np.asarray(out)


def test_bf16_step_matches_jax_bf16_step(step_case):
    """The port's bfloat16 step against JAX's, summed over the batches
    (a bfloat16 step's discrete choices, TAL's top-k and the mask loss's
    instances, follow its rounding, so one batch's parts move by chance):
    each loss part's distance, and the median tensor's gradient deviation,
    within STEP_MULTIPLE of JAX's bfloat16 drift from the float32 step;
    the port's own drift between a third and three times JAX's (the port
    really computes in bfloat16)."""
    for key, (err, jdrift, pdrift) in drifts(step_case).items():
        print(f"{key}: port bf16 - JAX bf16 {err:.4g}, JAX's drift "
              f"{jdrift:.4g}, the port's {pdrift:.4g} (sums over "
              f"{len(step_case)} batches)")
        assert err <= STEP_MULTIPLE * jdrift, key
        assert jdrift / 3 <= pdrift <= 3 * jdrift, key


def test_bf16_step_keeps_float32_state_and_bf16_heads(step_case):
    """After the bfloat16 step every variable, gradient, AdamW moment and
    EMA entry is float32, as in JAX's bfloat16 state (its tree's paths
    and shapes), and the network's heads are bfloat16."""
    case = step_case[0]
    tr = case["bf16"]["trainer"]
    jstate = case["jstate"]
    assert all(t.dtype == BF16 for k in ("box", "cls", "coef")
               for t in case["bf16"]["heads"][k])
    assert case["bf16"]["heads"]["proto"].dtype == BF16
    assert all(t.dtype == torch.float32
               for t in case["f32"]["heads"]["box"])
    trees = {"variables": (tr.variables(), jstate.variables),
             "ema": (tr.ema_variables(), jstate.ema_variables),
             "grads": (case["bf16"]["grads"], case["jgrads"]),
             "mu": (tr.opt_state_dict()["0"]["mu"],
                    jstate.opt_state[1][0].mu),
             "nu": (tr.opt_state_dict()["0"]["nu"],
                    jstate.opt_state[1][0].nu)}
    for what, (got, ref) in trees.items():
        got = got if what == "grads" else flat(got)
        ref = ref if what == "grads" else flat(ref)
        assert got.keys() == ref.keys(), what
        for key, value in ref.items():
            assert value.dtype == np.float32, (what, key)
            assert got[key].dtype == np.float32, (what, key)
            assert got[key].shape == value.shape, (what, key)
