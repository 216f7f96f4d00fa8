"""Metric meters and progress display.

Same observable surface as the reference's meters
(reference: lavila/utils/meter.py:12-65). A copy of
``lavila_tpu/utils/meters.py`` whose cross-process synchronization is an
``all_reduce`` over [sum, count] when ``torch.distributed`` is initialised
and a no-op in one process.
"""

from __future__ import annotations

import time
from typing import Optional


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)

    def synchronize(self):
        """All-reduce [sum, count] across processes (no-op unless
        ``torch.distributed`` is initialised with more than one)."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return
        import torch
        # NCCL reduces only tensors on the card
        where = "cuda" if dist.get_backend() == "nccl" else "cpu"
        arr = torch.tensor([self.sum, self.count], dtype=torch.float64,
                           device=where)
        dist.all_reduce(arr)
        self.sum, self.count = float(arr[0]), float(arr[1])
        self.avg = self.sum / max(self.count, 1e-12)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    def __init__(self, num_batches: int, meters: list, prefix: str = ""):
        width = len(str(num_batches))
        self.fmt = f"[{{:{width}d}}/{num_batches}]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        parts = [self.prefix + self.fmt.format(batch)]
        parts += [str(m) for m in self.meters]
        print("\t".join(parts), flush=True)

    def synchronize(self):
        for m in self.meters:
            m.synchronize()


class Timer:
    """Wall-clock timer for batch/data time accounting."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t
        self.t = now
        return dt
