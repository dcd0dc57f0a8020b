"""Short-budget probes of the agreement study's training arms.

Counterpart of the JAX package's `tools/agree_probe.py`: trains one or more
arms of `fast_exact_agreement` (`exact`, `fast`, `fast_w16`, `fast_f32`,
`fast_remat0` and their combinations such as `fast_w16_f32`; the names of
`fast_exact_agreement.mode_over`) for a short step budget on the same
scenes, and prints each arm's loss milestones (the mean of the 50 losses
before step 100, 200, 400, 600, 1000 and 2000, where the run reached it)
and its held-out AP and AP50, then a summary line. It never writes an
`AGREEMENT*.json`; with `--ckpt-dir` its train states go under a `probe/`
subdirectory keyed on the probe's budget, so a probe cannot reuse or
overwrite the full-length study's states.

    python -m trackformer_tpu_torch.tools.agree_probe 600 flagship \\
        fast_w16 fast_f32
    python -m trackformer_tpu_torch.tools.agree_probe 5 small fast_w16 \\
        --device cpu

The environment knobs of `fast_exact_agreement` (`AGREE_LR`,
`AGREE_WARMUP`, `AGREE_SEED`, `AGREE_MAX_STEPS`) apply. The model trains on
the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import fast_exact_agreement as ag

MILESTONES = (100, 200, 400, 600, 1000, 2000)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("steps", type=int, help="step budget of each arm")
    ap.add_argument("scale", choices=sorted(ag.SCALES))
    ap.add_argument("modes", nargs="+", help="arms, e.g. fast_w16 fast_f32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resumable train states go under <dir>/probe/")
    args = ap.parse_args(argv)
    for mode in args.modes:
        ag.mode_over(mode)   # an unknown token or window raises here
    return args


def milestones(losses: List[float]) -> Dict[int, float]:
    """The mean of the 50 losses before each milestone the run reached."""
    return {s: round(float(np.mean(losses[max(0, s - 50):s])), 2)
            for s in MILESTONES if len(losses) >= s}


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    sc = ag.SCALES[args.scale]
    seed = int(os.environ.get("AGREE_SEED", "0"))
    max_steps = int(os.environ.get("AGREE_MAX_STEPS", str(10 ** 9)))
    ckpt_dir = None
    if args.ckpt_dir:
        ckpt_dir = Path(args.ckpt_dir) / "probe"
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    def log(msg):
        print(msg, flush=True)

    train_scenes, eval_scenes = ag.make_scenes(sc)
    gt = ag.boxes_to_anns(eval_scenes)
    summary = {}
    for mode in args.modes:
        preds, losses = ag.train_and_eval(
            mode, train_scenes, eval_scenes, sc, args.steps, args.device,
            ckpt_dir, seed, max_steps, log)
        ap_, ap50 = ag.eval_map(preds, gt, sc)
        summary[mode] = {"ap": round(ap_, 4), "ap50": round(ap50, 4),
                         "loss": milestones(losses),
                         "steps": len(losses)}
        log(f"PROBE {mode}: AP={ap_:.4f} AP50={ap50:.4f} "
            f"loss={summary[mode]['loss']}")
    log(f"PROBE SUMMARY: {summary}")
    return summary


if __name__ == "__main__":
    main()
