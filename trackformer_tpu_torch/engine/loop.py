"""The training epoch loop.

Counterpart of `train_one_epoch` in `trackformer_tpu/engine/loop.py`: the
loop over the loader, the abort on a non-finite loss, a plain meter of the
metrics, and a `torch.profiler` trace of a few steady steps where the JAX
package starts its own. The evaluation loop waits for the datasets.
"""
from __future__ import annotations

import math
import sys
from typing import Callable, Dict, Iterable, Optional

import torch


class Meter:
    """Running global average of each metric."""

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    def update(self, **values: float) -> None:
        for k, v in values.items():
            self.total[k] = self.total.get(k, 0.0) + v
            self.count[k] = self.count.get(k, 0) + 1

    def averages(self) -> Dict[str, float]:
        return {k: self.total[k] / self.count[k] for k in self.total}


def train_one_epoch(train_step: Callable, state, loader: Iterable[Dict],
                    device_put: Callable[[Dict], Dict], epoch: int,
                    generator: Optional[torch.Generator],
                    print_freq: int = 50, profile_dir: str = "",
                    profile_steps: int = 8):
    """One training epoch -> (state, the metrics' averages). `device_put`
    moves a pack of the loader onto the model's device. With `profile_dir`
    a `torch.profiler` trace of steps [2, 2 + profile_steps) is written
    there as a Chrome trace."""
    meter = Meter()
    profiler = None

    def stop_profiler():
        profiler.stop()
        path = f"{profile_dir}/train_epoch{epoch}.json"
        profiler.export_chrome_trace(path)
        print(f"profiler trace written to {path}")

    for step, pack in enumerate(loader):
        if profile_dir and step == 2:
            profiler = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            profiler.start()
        state, metrics = train_step(state, device_put(pack), generator)
        loss_value = float(metrics["loss"])
        if profiler is not None and step >= 2 + profile_steps - 1:
            stop_profiler()
            profiler = None
        values = {k: float(v) for k, v in metrics.items()
                  if not k.startswith("_")}
        if not math.isfinite(loss_value):
            if profiler is not None:
                stop_profiler()
            print(f"Loss is {loss_value}, stopping training")
            print(values)
            sys.exit(1)
        meter.update(**values)
        if print_freq and step % print_freq == 0:
            print(f"Epoch: [{epoch}] step {step} " + " ".join(
                f"{k}={v:.4f}" for k, v in values.items()), flush=True)
    if profiler is not None:  # the epoch was shorter than the trace window
        stop_profiler()
    return state, meter.averages()
