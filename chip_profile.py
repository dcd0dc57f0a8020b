#!/usr/bin/env python3
"""Where the time goes in the port's tracking step, on one NVIDIA GPU.

    python3 chip_profile.py [--frames 8] [--seed 0] [--out DIR]

For each path — the exact mode through `Tracker` (B = 1), the TPU-fast mode
through `Tracker` (B = 1) and through `BatchedTracker` (8 sequences in
lockstep) — with the full-width model, seeded random weights and the
synthetic 800x1344 frames of `chip_smoke.py`:

  * step ms: host clock around each step, ending in a synchronize; the
    median over the steady steps (the first two excluded);
  * model ms: the model's forward alone on a steady step's inputs, and the
    backbone's alone (CUDA events, median of 10);
  * a `torch.profiler` trace of 4 steps (B = 1: steady steps of the run
    above; B = 8: one lockstep run of 4 frames, whose steps all have the
    same static shapes): device time per step, the device's busy share of
    the traced steps' wall time (`device_busy_share`; the tracer slows the
    host) and of the untraced steady step above
    (`device_share_of_untraced_step`), kernel launches per step, and the
    device time by operator (top 12).

One JSON line per path, also written to `--out DIR` when given.

Exits non-zero without a CUDA device. Measures only; checks nothing that
`chip_smoke.py` does not already check.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Optional

import torch

REPO = Path(__file__).resolve().parent


def profile_steps(step, n: int):
    """(device ms per step, wall ms per step, launches per step, top ops)
    over n steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.device_time for e in kernels) / 1e3 / n
    by_op = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0:
            by_op[e.key] = (t / 1e3 / n, e.count / n)
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:12]
    return dev, wall, len(kernels) / n, [
        {"op": k[:80], "ms_per_step": round(v[0], 4),
         "calls_per_step": round(v[1], 2)} for k, v in top]


def run_path(tag: str, cfg, batch: int, n_frames: int, seed: int,
             out_dir: Optional[Path]):
    from chip_smoke import frame_blobs, smoke_model, time_ms
    from trackformer_tpu_torch.structures import FrameBatch, empty_targets
    from trackformer_tpu_torch.tracking import BatchedTracker, Tracker

    model, post = smoke_model(cfg, seed, tag)
    tracker_cfg = {**cfg.tracker_cfg, "max_tracks": cfg.max_tracks}
    seqs = [frame_blobs(n_frames, seed + 100 * (i + 1))
            for i in range(batch)]
    step_ms = []
    if batch == 1:
        tracker = Tracker(model, post, tracker_cfg, cfg.hidden_dim,
                          cfg.num_queries, overflow_boxes=cfg.overflow_boxes)
        for blob in seqs[0]:
            t0 = time.perf_counter()
            tracker.step(blob)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        steady = iter(seqs[0][2:] * 2)

        def profiled():
            tracker.step(next(steady))
        n_prof = 4
    else:
        tracker = BatchedTracker(model, post, tracker_cfg, cfg.hidden_dim,
                                 cfg.num_queries,
                                 overflow_boxes=cfg.overflow_boxes)
        ends = []

        def logger(t, _):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.run(seqs, logger=logger)
        step_ms = [(b - a) * 1e3 for a, b in zip([t0] + ends, ends)]

        # one lockstep run of 4 frames; the shapes of every step are
        # static, so its mean step stands for a steady one
        def profiled():
            tracker.run([s[:4] for s in seqs])
        n_prof = 1

    # the model alone on a steady step's inputs: full track-query slots and
    # the previous step's features
    dev = torch.device("cuda")
    blobs = [s[-1] for s in seqs]
    fb = FrameBatch(images=torch.cat([b["batch"].images for b in blobs]),
                    mask=torch.cat([b["batch"].mask for b in blobs]))
    s_max, c = cfg.max_tracks, cfg.hidden_dim
    targets = empty_targets(batch, 1, dev).with_track_queries(
        torch.randn(batch, s_max, c, device=dev),
        torch.rand(batch, s_max, 4, device=dev) * 0.5 + 0.25,
        torch.ones(batch, s_max, dtype=torch.bool, device=dev))
    prev = model(fb, targets, None)[2]
    model_ms = time_ms(lambda: model(fb, targets, prev), 10)
    backbone_ms = time_ms(lambda: model.backbone[0](fb), 10)

    dev_ms, wall_ms, launches, top = profile_steps(profiled, n_prof)
    if batch > 1:  # one run of 4 lockstep steps
        dev_ms, wall_ms, launches = dev_ms / 4, wall_ms / 4, launches / 4
        top = [dict(t, ms_per_step=round(t["ms_per_step"] / 4, 4),
                    calls_per_step=round(t["calls_per_step"] / 4, 2))
               for t in top]
    steady_ms = statistics.median(step_ms[2:])
    line = {"path": tag, "batch": batch,
            "steady_step_ms": steady_ms,
            "step_ms": [round(t, 2) for t in step_ms],
            "model_forward_ms": model_ms, "backbone_ms": backbone_ms,
            "profiled_device_ms_per_step": dev_ms,
            "profiled_wall_ms_per_step": wall_ms,
            "device_busy_share": dev_ms / wall_ms,
            "device_share_of_untraced_step": dev_ms / steady_ms,
            "kernel_launches_per_step": launches, "top_device_ops": top}
    print(json.dumps(line), flush=True)
    if out_dir is not None:
        (out_dir / f"profile_{tag}.json").write_text(json.dumps(line,
                                                                indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import subprocess

    from trackformer_tpu_torch.ops import msda, window_attn
    from trackformer_tpu_torch.ops.cuda_build import build_all
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build_all([msda.LIB, window_attn.LIB])
    out_dir = None if args.out is None else Path(args.out)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    exact = FlagshipConfig().replace(dataset="mot_crowdhuman")
    fast = FlagshipConfig.tpu_fast(dataset="mot_crowdhuman")
    with torch.inference_mode():
        run_path("exact_b1", exact, 1, args.frames, args.seed, out_dir)
        run_path("fast_b1", fast, 1, args.frames, args.seed, out_dir)
        run_path("fast_b8", fast, 8, args.frames, args.seed, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
