#!/usr/bin/env python3
"""Times MSDA kernels #1 (the encoder call, `msda_patch`) and #2 (the
decoder call, `ms_deform_attn`) on a trained model's own sampling
locations, beside the same calls of the same model at its random init.

    python3 chip_trained_offsets.py --state DIR/agreement_flagship_2000_exact_train.pt \\
        [--steps 2000] [--scale flagship]

`--state` is the train state that `trackformer_tpu_torch.tools.
fast_exact_agreement` saves in its `--ckpt-dir` (the exact arm). The
model is rebuilt from the tool's config at that scale; one eval forward of
the first held-out batch is run at init (seed 0) and with the trained
weights, every MSDA call's inputs recorded, and each call re-timed through
its wrapper (CUDA events, median). Prints one line per call and a JSON
summary: per call the kernel ms at init and trained, the samples outside
[0, 1], the mean distance of a sample from the centre of its (query,
head)'s samples in cells of the finest level, and the bound. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent


def record_calls(model, batch):
    """Every MSDA call of one eval forward: (value, shapes, loc, attn)."""
    from trackformer_tpu_torch.models import deformable_transformer as dt
    real = dt.ms_deform_attn
    seen = []

    def recorder(value, spatial_shapes, loc, attn):
        seen.append((value.detach().clone(),
                     tuple(tuple(hw) for hw in spatial_shapes),
                     loc.detach().clone(), attn.detach().clone()))
        return real(value, spatial_shapes, loc, attn)

    dt.ms_deform_attn = recorder
    try:
        with torch.inference_mode():
            model(batch)
    finally:
        dt.ms_deform_attn = real
    return [tuple(x.clone() if torch.is_tensor(x) else x for x in call)
            for call in seen]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--state", required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--scale", default="flagship")
    ap.add_argument("--out", default=None, help="JSON summary file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_trained_offsets: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import msda_bound, time_ms
    from trackformer_tpu_torch.engine import TrainState, make_optimizer
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_patch import msda_patch
    from trackformer_tpu_torch.structures import FrameBatch
    from trackformer_tpu_torch.tools import fast_exact_agreement as agree
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sc = agree.SCALES[args.scale]
    cfg, opt_cfg = agree.train_config("exact", sc, args.steps)
    model_cfg = FlagshipConfig.from_config(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model, _, _, _ = build_model(model_cfg, "cuda", generator=gen,
                                 train=True)
    _, held_out = agree.make_scenes(sc)
    imgs = torch.as_tensor(np.stack([s[0] for s in held_out[:sc.batch]]),
                           device="cuda")
    batch = FrameBatch.from_images(
        imgs, torch.tensor([[sc.h, sc.w]] * sc.batch, device="cuda"))
    model.eval()
    calls = {"init": record_calls(model, batch)}
    opt = make_optimizer(model_cfg, model,
                         lr_drop_steps=opt_cfg["lr_drop_steps"])
    state = TrainState.create(model, opt)
    agree.restore_train(Path(args.state), state, model)
    model.eval()
    calls["trained"] = record_calls(model, batch)

    finest = sc.h / 8.0, sc.w / 8.0
    summary = []
    for i, (c_init, c_trained) in enumerate(zip(calls["init"],
                                                calls["trained"])):
        row = {"call": i}
        for tag, (value, shapes, loc, attn) in (("init", c_init),
                                                ("trained", c_trained)):
            encoder = loc.shape[1] == value.shape[1]
            if encoder:
                def fn():
                    return msda_patch(value, shapes, loc, attn)
            else:
                def fn():
                    return msda.ms_deform_attn(value, shapes, loc, attn)
            ms = time_ms(fn, 20, 5)
            bound_ms, bound_by = msda_bound(value, loc, attn)
            centre = loc.mean(dim=(3, 4), keepdim=True)
            spread = ((loc - centre) * torch.tensor(
                [finest[1], finest[0]], device=loc.device)).norm(
                    dim=-1).mean().item()
            outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
            row.update({"kernel": "msda_patch (#1)" if encoder
                        else "ms_deform_attn (#2)",
                        "items": value.shape[0], "queries": loc.shape[1],
                        "levels": len(shapes), "channels": value.shape[3],
                        f"{tag}_ms": round(ms, 4),
                        f"{tag}_samples_outside": round(outside, 4),
                        f"{tag}_spread_cells": round(spread, 3),
                        "bound_ms": round(bound_ms, 4),
                        "bound_by": bound_by})
        print(json.dumps(row), flush=True)
        summary.append(row)
    result = {"device": smi, "scale": sc.name, "state": str(args.state),
              "calls": summary}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
