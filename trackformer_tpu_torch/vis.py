"""Training visualization: JSONL metric streams and matplotlib plots
under `output_dir/vis/`.

Counterpart of `trackformer_tpu/vis.py`'s `FileVis` and
`build_visualizers`: `iter_metrics.jsonl` and `epoch_metrics.jsonl` are
always written; the plot of the epoch metrics is skipped, as there, where
matplotlib does not import (the card's machine has none). The JAX
module's example renderer (`vis_results`), which no caller uses, is not
ported.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, Optional

import numpy as np


class FileVis:
    def __init__(self, output_dir: str):
        self.dir = osp.join(output_dir, "vis")
        os.makedirs(self.dir, exist_ok=True)
        self._iter = open(osp.join(self.dir, "iter_metrics.jsonl"), "a")
        self._epoch = open(osp.join(self.dir, "epoch_metrics.jsonl"), "a")
        self._step = 0

    def log_iter(self, metrics: Dict[str, float]):
        self._step += 1
        rec = {"step": self._step}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._iter.write(json.dumps(rec) + "\n")
        self._iter.flush()

    def log_epoch(self, epoch: int, metrics: Dict[str, float]):
        rec = {"epoch": epoch}
        # ndarray has .item too — require 0-d, else float() throws
        rec.update({k: float(v) for k, v in metrics.items()
                    if np.isscalar(v)
                    or (hasattr(v, "item") and np.ndim(v) == 0)})
        self._epoch.write(json.dumps(rec) + "\n")
        self._epoch.flush()
        self.plot_curves()

    def plot_curves(self):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        path = osp.join(self.dir, "epoch_metrics.jsonl")
        if not osp.exists(path):
            return
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        if not rows:
            return
        keys = sorted({k for r in rows for k in r if k != "epoch"})
        n = len(keys)
        if not n:
            return
        cols = min(4, n)
        fig, axes = plt.subplots((n + cols - 1) // cols, cols,
                                 figsize=(4 * cols,
                                          3 * ((n + cols - 1) // cols)),
                                 squeeze=False)
        for i, k in enumerate(keys):
            ax = axes[i // cols][i % cols]
            xs = [r["epoch"] for r in rows if k in r]
            ys = [r[k] for r in rows if k in r]
            ax.plot(xs, ys)
            ax.set_title(k, fontsize=9)
        fig.tight_layout()
        fig.savefig(osp.join(self.dir, "epoch_metrics.png"))
        plt.close(fig)


def build_visualizers(args) -> Optional[FileVis]:
    if getattr(args, "no_vis", False) or not getattr(args, "output_dir", ""):
        return None
    if getattr(args, "eval_only", False) or getattr(args, "debug", False):
        return None
    return FileVis(args.output_dir)
