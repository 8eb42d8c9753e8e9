"""A toy model family for the harness's tests: the system multiplies the
chunk's rows by a seeded matrix and takes tanh, in float32 on the device;
the reference does the same in float64 with numpy, and ``max_gap`` is the
widest gap over the sampled outputs."""

from __future__ import annotations

import types

import numpy as np
import torch

NUMBERS = ("max_gap", "launch_mismatch")
PATH_KERNELS, OFF_PATH_KERNELS = (), ()
FAULTS = {}


class ToySystem:
    def __init__(self, root, cell, device, workdir=None, spans=None):
        self.device = torch.device(device)

    def step(self, chunk):
        x = torch.as_tensor(chunk.x, device=self.device)
        w = torch.as_tensor(chunk.w, device=self.device)
        return torch.tanh(x @ w)

    @staticmethod
    def launches():
        return {}

    @staticmethod
    def build_info():
        return {}


make_system = control_system = ToySystem


def make_chunk(root, cell, seed, chunk=0):
    rng = np.random.default_rng(seed % 2 ** 64)
    n, width = chunk or int(cell.mix["chunk"]), int(cell.config["width"])
    return types.SimpleNamespace(
        x=rng.standard_normal((n, width), np.float32),
        w=rng.standard_normal((width, width), np.float32) / width ** 0.5,
        frames=n)


def sample(out):
    return {"y": out}


def operands(system, chunk):
    return system.step(chunk)


def layer_context(cell, record):
    return {"model_flops_per_frame": 2 * int(cell.config["width"]) ** 2}


def judge(root, cell, device, chunk, samples, launch_mismatch):
    want = np.tanh(chunk.x.astype(np.float64) @ chunk.w.astype(np.float64))
    gap = max((float(np.abs(s["y"] - want).max()) for s in samples),
              default=float("inf"))
    numbers = {"max_gap": gap, "launch_mismatch": launch_mismatch}
    limits = cell.config["limits"]
    return numbers, all(numbers[k] <= limits[k] for k in NUMBERS)
