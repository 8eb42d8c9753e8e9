"""The benchmark's one traffic generator, driven by a mix's data file.

A mix (``benchmark/traffic/<name>.json``) gives the chunk size, the
photometric jitter that makes frames from the committed camera frames,
the scan's slots and how many points a sweep has, and the GT box slots.
A run makes one chunk from the seed, on the host, as the stream's
consumer receives it: (B, H, W, 3) uint8 frames, (B, P, 4) float32 scans
with a validity mask, (B, G, 8, 3) float32 cam0 corners with theirs; the
window sends that chunk again and again.

Every seed gets the same set of sizes in another order: the frames'
sources and the sweep sizes are fixed lists over the chunk, permuted by
the seed; the jitter and the scenes' geometry are drawn from it.  The GT
boxes lie behind the cars that the configuration's reference finds in
each committed frame (``benchmark/data/cars/<config>.json``, written by
``benchmark/tools/make_cars.py``).

The committed frames are the seg overlays of the repository's artifacts:
camera frames with an earlier detector's masks and boxes painted over
the cars, in which the detectors find fewer cars than the drive holds
(x 2 and 1, n 3 and 6, against 6 in each frame's committed rows).  The
checkpoints were distilled on these frames: a mirror or a shift of a few
pixels loses their cars, a jitter of a few per cent does not.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np

from benchmark.harness import scene
from benchmark.harness.png import read_png_rgb

H0, W0 = 376, 1408


@dataclasses.dataclass
class Chunk:
    """One chunk's arrays, as the consumer of the stream receives them."""

    images: np.ndarray        # (B, H, W, 3) uint8
    points: np.ndarray        # (B, P, 4) float32
    point_valid: np.ndarray   # (B, P) bool
    corners: np.ndarray       # (B, G, 8, 3) float32, cam0
    box_valid: np.ndarray     # (B, G) bool

    @property
    def frames(self) -> int:
        return int(self.images.shape[0])


def cars_path(root: str, config: str) -> str:
    return os.path.join(root, "benchmark", "data", "cars", f"{config}.json")


def load_cars(root: str, config: str, sources: List[str]):
    """Per committed frame: the reference's car boxes (N, 4)."""
    with open(cars_path(root, config)) as f:
        cars = json.load(f)
    if cars["frames"] != list(sources):
        raise ValueError(f"{cars_path(root, config)} was made from "
                         f"{cars['frames']}, the mix reads {sources}")
    return [np.asarray(boxes, np.float32).reshape(-1, 4)
            for boxes in cars["boxes"]]


def _spread(lo, hi, n: int, rng) -> np.ndarray:
    """n values evenly over [lo, hi], in an order drawn from ``rng``."""
    return rng.permutation(np.linspace(lo, hi, n))


def _jitter(image: np.ndarray, gain: float, channel: np.ndarray,
            bias: float) -> np.ndarray:
    """The frame's levels mapped by ``gain * channel * x + bias``."""
    levels = np.arange(256, dtype=np.float32)
    lut = np.clip(np.rint(levels[None, :] * (gain * channel[:, None])
                          + bias), 0, 255).astype(np.uint8)      # (3, 256)
    return np.stack([lut[c][image[..., c]] for c in range(3)], -1)


def _cull(points: np.ndarray, valid: np.ndarray, depth_max: float):
    """The points of a sweep that fall in the camera's view between 0 and
    ``depth_max`` m, as a compaction to the camera frustum keeps them."""
    xyz = points[:, :3].astype(np.float64)
    rect = xyz @ scene.VELO_TO_RECT[:3, :3].T.astype(np.float64)
    proj = rect @ scene.INTRINSICS.T.astype(np.float64)
    depth = proj[:, 2]
    safe = np.where(np.abs(depth) > 1e-9, depth, 1.0)
    u, v = proj[:, 0] / np.abs(safe), proj[:, 1] / np.abs(safe)
    keep = (valid & (depth > 0) & (depth < depth_max) & (u >= -1)
            & (u < W0 + 1) & (v >= -1) & (v < H0 + 1))
    return points[keep]


def make_chunk(root: str, mix: dict, config: dict, seed: int,
               chunk: int = 0) -> Chunk:
    """The chunk for ``seed`` (``chunk`` > 0 overrides the mix's chunk
    size, for tests)."""
    rng = np.random.default_rng(seed % 2 ** 64)
    n = chunk or int(mix["chunk"])
    fr, sc, bx = mix["frames"], mix["scan"], mix["boxes"]
    sources = [os.path.join(root, s) for s in fr["sources"]]
    base = [read_png_rgb(p) for p in sources]
    cars = load_cars(root, config["name"], fr["sources"])
    frames = [k % len(base) for k in rng.permutation(n)]
    sweeps = np.rint(_spread(*sc["sweep_points"], n, rng)).astype(int)
    slots, g = int(sc["slots"]), int(bx["slots"])
    depth_max = float(config["fusion"]["depth_max"])
    images = np.empty((n, H0, W0, 3), np.uint8)
    points = np.zeros((n, slots, 4), np.float32)
    point_valid = np.zeros((n, slots), bool)
    corners = np.zeros((n, g, 8, 3), np.float32)
    box_valid = np.zeros((n, g), bool)
    for i in range(n):
        channel = 1.0 + rng.uniform(-fr["channel_gain"], fr["channel_gain"],
                                    3).astype(np.float32)
        images[i] = _jitter(base[frames[i]], rng.uniform(*fr["gain"]),
                            channel, rng.uniform(*fr["bias"]))
        boxes = cars[frames[i]]
        pts, pv, c, bv = scene.make_scene(
            rng, boxes, np.ones(len(boxes), bool), num_points=int(sweeps[i]),
            num_boxes=g, num_valid=int(bx["valid"]),
            surround=bool(sc["surround"]))
        kept = _cull(pts, pv, depth_max) if sc["cull_to_view"] \
            else pts[pv]
        if len(kept) > slots:
            raise ValueError(f"{len(kept)} points do not fit {slots} slots")
        points[i, :len(kept)] = kept
        point_valid[i, :len(kept)] = True
        corners[i], box_valid[i] = c, bv
    return Chunk(images, points, point_valid, corners, box_valid)
