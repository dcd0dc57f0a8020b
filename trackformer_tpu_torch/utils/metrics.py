"""Smoothed training meters and the epoch logger.

Counterpart of `trackformer_tpu/utils/metrics.py` (the original's
`SmoothedValue` and `MetricLogger.log_every`, with iteration and data
timing). The cross-process sync of a meter's count and total is an
all-reduce through `torch.distributed` when a process group is
initialized, and nothing otherwise.
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable

import torch
import torch.distributed as dist


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} "
                 "({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self) -> None:
        """Sum the count and the total over the process group (the window
        stays local, as in the original)."""
        if not _distributed():
            return
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=device)
        dist.all_reduce(t)
        self.count, self.total = int(t[0].item()), float(t[1].item())

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    def __init__(self, print_freq: int = 50, delimiter: str = "  ",
                 vis=None, debug: bool = False):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.print_freq = print_freq
        self.delimiter = delimiter
        self.vis = vis
        self.debug = debug

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, header: str = ""):
        i = 0
        total = len(iterable) if hasattr(iterable, "__len__") else None
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % self.print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                tot = f"/{total}" if total else ""
                print(f"{header} [{i}{tot}]  {eta}{self}  "
                      f"time: {iter_time}  data: {data_time}")
                if self.vis is not None:
                    self.vis.log_iter(
                        {k: m.value for k, m in self.meters.items()})
            i += 1
            end = time.time()
            if self.debug and i >= 2:
                break
        elapsed = time.time() - start
        print(f"{header} Total time: "
              f"{datetime.timedelta(seconds=int(elapsed))}")
