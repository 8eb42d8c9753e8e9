"""Process-group bring-up for scale-out, and a launcher of local ranks.

Counterpart of ``lidar_object_detection_tpu/parallel/distributed.py``:
where JAX brings up ``jax.distributed``, the port brings up a
``torch.distributed`` process group, from its arguments or from the
variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``).  The same program runs on every rank:

    from lidar_object_detection_tpu_torch.parallel import (
        distributed, make_mesh)
    distributed.initialize()            # torchrun's environment
    mesh = make_mesh(model_parallel=2)  # (world / 2, 2) over the cards

The backend is NCCL on the card and gloo on the CPU.  NCCL refuses two
ranks on one card, so where a host's ranks outnumber its cards they take
gloo, which carries CUDA tensors too.  A lost rank fails the step, as a
lost JAX host does.

:func:`spawn` starts local ranks in fresh processes under a
hard timeout, each with the group brought up over a file store, and
returns what each rank's function returned: the CPU tests and the dry
run (:mod:`.dryrun`) use it.

    python -m lidar_object_detection_tpu_torch.parallel.distributed \\
        RANK WORLD JOB_DIR

is a rank of :func:`spawn`'s; nothing else runs it.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

_MODULE = "lidar_object_detection_tpu_torch.parallel.distributed"
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def default_backend(device, local_ranks: int) -> str:
    """gloo on the CPU; on the card NCCL, or gloo where the host's
    ``local_ranks`` outnumber its cards (NCCL refuses two ranks on one
    card)."""
    if torch.device(device).type == "cuda" \
            and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> bool:
    """Bring up ``torch.distributed``.  Returns True if this call brought
    the group up; a second call is a no-op (False), as JAX's.

    Args:
      coordinator_address: ``host:port`` of rank 0's store, or an init
        URL (``tcp://...``, ``file://...``); by default torchrun's
        ``MASTER_ADDR`` and ``MASTER_PORT``.
      num_processes, process_id: the world size and this rank; by default
        ``WORLD_SIZE`` and ``RANK``.  With neither given nor set, a world
        of one comes up over an in-process store, so that every sharded
        path also runs on one card (JAX's 1 x 1 mesh).
      backend: "nccl" or "gloo"; by default gloo for ``device`` "cpu",
        and for "cuda" NCCL, or gloo where this host's ranks
        (``LOCAL_WORLD_SIZE``, else the world) outnumber its cards.
      device: "cuda" (the default: this rank's card, ``LOCAL_RANK``
        modulo the cards, becomes the current device) or "cpu".
    """
    if dist.is_initialized():
        return False
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but CUDA is "
                               "not available; pass device='cpu' to run "
                               "the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    backend = backend or default_backend(
        device, int(env.get("LOCAL_WORLD_SIZE", num_processes or 1)))
    if num_processes is None:
        if coordinator_address is not None:
            raise ValueError("a coordinator address needs num_processes")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return True
    if process_id is None:
        raise ValueError("num_processes needs process_id (or RANK)")
    init = ("env://" if coordinator_address is None
            else _init_method(coordinator_address))
    dist.init_process_group(backend, init_method=init, rank=process_id,
                            world_size=num_processes)
    return True


def is_primary() -> bool:
    """True on the rank that writes checkpoints and CSVs and prints: rank
    0, or the only process when no group is up."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# local ranks in fresh processes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RankRun:
    """What one rank of :func:`spawn` returned and printed."""

    value: Any
    stdout: str


def _tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def spawn(target: str, world: int, args: Sequence = (), *,
          timeout: float = 300.0, device="cuda", path: Sequence[str] = (),
          workdir: Optional[str] = None, threads: int = 1
          ) -> List[RankRun]:
    """Run ``target`` (``"module:function"``) on ``world`` local ranks,
    each in a fresh interpreter with the group up, and return each
    rank's :class:`RankRun` in rank order.

    Each rank gets torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
    and ``LOCAL_WORLD_SIZE``, runs on ``device`` ("cuda", the default:
    NCCL, or gloo where the ranks outnumber the cards; or "cpu": gloo)
    with a file store in ``workdir`` (a new temporary directory by
    default), calls ``function(*args)`` (``args`` are
    pickled) with ``threads`` PyTorch threads, pickles what it returns,
    and destroys its group.  ``path`` entries go before the package's
    root on ``sys.path``.  The ranks share ``timeout`` seconds: past it,
    or when a rank fails, every rank is killed and this raises with the
    ranks' error output.
    """
    own = workdir is None
    job = tempfile.mkdtemp(prefix="ranks_") if own else workdir
    os.makedirs(job, exist_ok=True)
    with open(os.path.join(job, "job.pkl"), "wb") as f:
        pickle.dump({"target": target, "args": tuple(args),
                     "device": str(device), "threads": threads}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [*path, PACKAGE_ROOT, *filter(None, [env.get("PYTHONPATH")])])
    env["WORLD_SIZE"] = env["LOCAL_WORLD_SIZE"] = str(world)
    procs, files = [], []
    failed = None
    try:
        for rank in range(world):
            env_r = dict(env, RANK=str(rank), LOCAL_RANK=str(rank))
            files += [open(os.path.join(job, f"rank{rank}.{kind}"), "w")
                      for kind in ("out", "err")]
            procs.append(subprocess.Popen(
                [sys.executable, "-m", _MODULE, str(rank), str(world), job],
                env=env_r, stdout=files[-2], stderr=files[-1], cwd=job))
        deadline = time.monotonic() + timeout
        pending = list(range(world))
        while pending and failed is None:
            for rank in list(pending):
                code = procs[rank].poll()
                if code is None:
                    continue
                pending.remove(rank)
                if code != 0:
                    failed = f"rank {rank} exited with {code}"
            if pending and failed is None:
                if time.monotonic() > deadline:
                    failed = f"the ranks exceeded {timeout:.0f} s"
                else:
                    time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        for f in files:
            f.close()
    if failed is not None:
        errors = "\n".join(
            f"--- rank {r} ---\n{_tail(os.path.join(job, f'rank{r}.err'))}"
            for r in range(world))
        raise RuntimeError(f"spawn({target!r}, {world}): {failed}\n"
                           f"{errors}")
    runs = []
    for rank in range(world):
        with open(os.path.join(job, f"rank{rank}.pkl"), "rb") as f:
            value = pickle.load(f)
        with open(os.path.join(job, f"rank{rank}.out"),
                  errors="replace") as f:
            runs.append(RankRun(value, f.read()))
    if own:
        shutil.rmtree(job, ignore_errors=True)
    return runs


def _run_rank(rank: int, world: int, job: str) -> None:
    import importlib

    with open(os.path.join(job, "job.pkl"), "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    store = "file://" + os.path.join(job, "store")
    initialize(store, world, rank, device=spec["device"])
    try:
        value = fn(*spec["args"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(job, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(value, f)


if __name__ == "__main__":
    _run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
