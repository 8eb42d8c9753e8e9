"""Faults planted underneath the timed path, for showing that the
comparison catches them: half of the chunk's frames left out of the
detections, and an answer altered where it is produced (one car's inside
count).  Each takes a ``setattr``-like function (pytest's
``monkeypatch.setattr``, or ``setattr`` itself in a process of its own)
and patches the port.  Only ``benchmark/tests`` and ``benchmark/tools``
plant them; the benchmark's runs never do."""

from __future__ import annotations

import torch


def half_left_out(patch) -> None:
    """The decode's detections of the second half of the chunk zeroed."""
    from lidar_object_detection_tpu_torch.models.yolo import detector

    decode = detector.YoloDetector.decode

    def broken(self, outputs):
        out = decode(self, outputs)
        half = out["det_valid"].shape[0] // 2
        return {k: torch.cat([v[:half], torch.zeros_like(v[half:])])
                for k, v in out.items()}
    patch(detector.YoloDetector, "decode", broken)


def count_altered(patch) -> None:
    """The first matched car's inside count raised by one."""
    from lidar_object_detection_tpu_torch.pipelines import runner

    fuse = runner.fuse_batch

    def broken(*args, **kwargs):
        out = fuse(*args, **kwargs)
        car = torch.nonzero(out["matched"])[0]
        out["points_inside"][car[0], car[1]] += 1
        return out
    patch(runner, "fuse_batch", broken)


FAULTS = {"half_left_out": half_left_out, "count_altered": count_altered}
