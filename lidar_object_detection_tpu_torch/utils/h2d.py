"""Copies from the host to the card through a reused pinned ring.

A plain ``tensor.to("cuda")`` of pageable host memory goes through the
driver's own small staging buffer, one thread copying, while the host
waits, and in the order of the compute stream.  :func:`uploader` gives a
CUDA device's :class:`Uploader` instead, made at its first use and kept
for the life of the process: ``SLOTS`` slots of ``SLOT_BYTES``
page-locked host bytes, one side stream for the copies and one worker
thread.

:meth:`Uploader.submit` hands the worker a job: a list of host arrays.
The device tensors are allocated at once, on the caller's current
stream, and the side stream waits for an event recorded there before it
writes them.  The worker goes through each array slice by slice: it
copies the slice into a free slot (ATen's ``copy_``, which drops the
interpreter lock and spreads over ATen's threads), issues the copy from
the slot to the device on the side stream and records the slot's event,
which must complete before the slot is filled again.  So the host copy of
one slice overlaps the transfer of the one before.  A source already on
the card is not copied; a pinned source is copied directly on the side
stream, without the ring; a non-contiguous one takes the plain ``.to()``
path.  Every call copies all of its bytes: nothing is kept from one job
to the next but the slots themselves.

:meth:`Handle.result` makes the caller's current stream wait on the job's
last event and returns the device tensors; it never synchronises the
device.  An error in the worker is raised there.  The worker serves jobs
in the order they are queued.  A job submitted with ``after_next=True``
(the scans that ``FusionPipeline.detect`` sends ahead) waits until the
next job submitted without it (the frames' copy in
``YoloDetector.forward``) is queued, and is queued behind it, so that
the frames never wait behind it; ``Handle.release`` or ``result`` queues
it earlier.  Until its ``result``, such a job may still read its sources,
and the card's copy of a pinned source may run on after ``result``: the
caller leaves its sources as they are meanwhile.

Spans (``utils.profiling``): ``h2d.stage`` on the worker, one per job
that moves bytes, with the bytes that went through the ring; on the card
its events lie on the side stream.

On a device that is not CUDA (the tests' stand-in) the slots are plain
host memory, the "transfer" is a host copy and there are no events; the
pipelines do not use an uploader there (:func:`upload` copies with
``.to()``).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import threading
from typing import Dict, List, Optional, Sequence

import torch

from lidar_object_detection_tpu_torch.utils import profiling

# 16 MiB a slot, 4 slots, chosen on an H100 (PERF.md): 8 MiB slots
# staged about a fifth slower, larger ones no faster
SLOT_BYTES = 16 << 20
SLOTS = 4


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor."""
    return t.reshape(-1).view(torch.uint8)


class _Job:
    __slots__ = ("items", "outputs", "staged", "ready", "last", "error",
                 "done", "queued")

    def __init__(self):
        self.items: List[tuple] = []      # ("ring" | "direct", src, dst)
        self.outputs: Optional[List[torch.Tensor]] = []
        self.staged = 0                   # bytes that go through the ring
        self.ready = None                 # the caller's stream at submit
        self.last = None                  # after the job's last transfer
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.queued = False


class Handle:
    """One job of an :class:`Uploader`; its tensors are taken once."""

    def __init__(self, uploader: "Uploader", job: _Job):
        self._uploader = uploader
        self._job = job

    def release(self) -> None:
        """Queue the job now if it still waits for the next job."""
        if self._job is not None:
            self._uploader._queue_parked(self._job)

    def result(self) -> List[torch.Tensor]:
        """The device tensors, in the order of the sources, once the
        caller's current stream has been made to wait for their copies;
        raises the worker's error, and a second call."""
        job, self._job = self._job, None
        if job is None:
            raise RuntimeError("the tensors of this upload were already "
                               "taken")
        self._uploader._queue_parked(job)
        job.done.wait()
        if job.error is not None:
            raise job.error
        if job.last is not None:
            torch.cuda.current_stream(self._uploader.device).wait_event(
                job.last)
        outputs, job.outputs = job.outputs, None
        return outputs


class Uploader:
    """The ring, the side stream and the worker of one device (see the
    module's docstring).  ``slot_bytes`` and ``slots`` size the ring; the
    pipelines' uploaders (:func:`uploader`) take ``SLOT_BYTES`` and
    ``SLOTS``."""

    def __init__(self, device, slot_bytes: int = SLOT_BYTES,
                 slots: int = SLOTS):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slot_bytes = int(slot_bytes)
        self._slots = [torch.empty(self.slot_bytes, dtype=torch.uint8,
                                   pin_memory=self.cuda)
                       for _ in range(slots)]
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        # each slot's event follows its last transfer
        self._slot_done = [torch.cuda.Event() if self.cuda else None
                           for _ in range(slots)]
        self._next = 0
        self._cond = threading.Condition()
        self._queue: "collections.deque[_Job]" = collections.deque()
        self._parked: List[_Job] = []
        self._closed = False
        self._worker = threading.Thread(
            target=self._serve, name=f"h2d-{self.device}", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, sources: Sequence, after_next: bool = False) -> Handle:
        """Queue the copies of ``sources`` (numpy arrays or tensors) to the
        device; with ``after_next`` the job waits for the next job
        submitted without it, and is queued behind that one."""
        job = _Job()
        for src in sources:
            t = torch.as_tensor(src)
            if t.device.type != "cpu" or not t.is_contiguous():
                job.outputs.append(t.to(self.device))
                continue
            out = torch.empty(t.shape, dtype=t.dtype, device=self.device)
            job.outputs.append(out)
            if t.numel() == 0:
                continue
            if self.cuda:
                # the side stream writes ``out``: the allocator must not
                # hand its memory on before those writes are done, even
                # if the handle is dropped unread
                out.record_stream(self._stream)
            if self.cuda and t.is_pinned():
                job.items.append(("direct", t, out))
            else:
                # the slices' views are made here, where the caller holds
                # the interpreter lock anyway, not between the worker's
                # copies
                job.items.append(("ring", _bytes(t).split(self.slot_bytes),
                                  _bytes(out).split(self.slot_bytes)))
                job.staged += t.nbytes
        if job.items and self.cuda:
            job.ready = torch.cuda.Event()
            job.ready.record(torch.cuda.current_stream(self.device))
        with self._cond:
            if self._closed:
                raise RuntimeError(f"the uploader of {self.device} is closed")
            if after_next:
                self._parked.append(job)
            else:
                self._enqueue(job)
                for parked in self._parked:
                    self._enqueue(parked)
                self._parked.clear()
        return Handle(self, job)

    def _enqueue(self, job: _Job) -> None:
        """Under the lock: queue ``job`` for the worker, or finish a job
        with nothing to move at once."""
        job.queued = True
        if job.items:
            self._queue.append(job)
            self._cond.notify()
        else:
            job.done.set()

    def _queue_parked(self, job: _Job) -> None:
        with self._cond:
            if not job.queued:
                self._parked.remove(job)
                self._enqueue(job)

    def close(self) -> None:
        """Serve the jobs queued so far, then stop the worker."""
        with self._cond:
            self._closed = True
            for parked in self._parked:
                self._enqueue(parked)
            self._parked.clear()
            self._cond.notify()
        self._worker.join(timeout=60)

    # ------------------------------------------------------------------ worker
    def _serve(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:
                    return
                job = self._queue.popleft()
            self._run(job)
            del job

    def _run(self, job: _Job) -> None:
        try:
            with (torch.cuda.stream(self._stream) if self.cuda
                  else contextlib.nullcontext()):
                with profiling.span("h2d.stage", self.device,
                                    nbytes=job.staged):
                    if job.ready is not None:
                        self._stream.wait_event(job.ready)
                    for kind, src, dst in job.items:
                        if kind == "direct":
                            dst.copy_(src, non_blocking=True)
                        else:
                            self._stage(src, dst)
                    if self.cuda:
                        job.last = torch.cuda.Event()
                        job.last.record(self._stream)
        except Exception as exc:  # noqa: BLE001 -- raised by result()
            job.error = exc
        finally:
            job.items = []
            job.done.set()

    def _stage(self, srcs, dsts) -> None:
        """Each slice of ``srcs`` into the next slot, and on to its slice
        of ``dsts``."""
        for src, dst in zip(srcs, dsts):
            i = self._next
            self._next = (i + 1) % len(self._slots)
            slot = self._slots[i]
            if src.numel() < self.slot_bytes:
                slot = slot[:src.numel()]
            if self.cuda:
                self._slot_done[i].synchronize()
            slot.copy_(src)
            dst.copy_(slot, non_blocking=True)
            if self.cuda:
                self._slot_done[i].record(self._stream)


_uploaders: Dict[int, Uploader] = {}
_lock = threading.Lock()


def uploader(device) -> Uploader:
    """The CUDA ``device``'s uploader, made at its first use."""
    device = torch.device(device)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _lock:
        up = _uploaders.get(index)
        if up is None:
            up = _uploaders[index] = Uploader(torch.device("cuda", index))
            atexit.register(up.close)
        return up


def upload(sources: Sequence, device) -> List[torch.Tensor]:
    """``sources`` (numpy arrays or tensors) on ``device``: through the
    device's uploader on a CUDA device, with ``.to()`` on any other."""
    device = torch.device(device)
    if device.type != "cuda":
        return [torch.as_tensor(s).to(device) for s in sources]
    return uploader(device).submit(sources).result()

