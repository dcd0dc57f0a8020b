#!/usr/bin/env python3
"""Where a resumed training step's drift on the card comes from.

    python3 chip_resume_drift.py [--seed 0] [--out FILE]

The full-width TPU-fast flagship (`chip_smoke.py`'s `checkpoint` phase)
takes two bf16 train steps at B = 2 on the synthetic pack; then its third
step is taken several times from the same state with the same draws:

  * `replay_a`, `replay_b`: the same in-memory state twice;
  * `pinned`: once more, every `msda_bwd` launch returning `replay_a`'s
    output of that launch (so the backward kernel's float32 atomics cannot
    move it);
  * `pinned_deterministic`: as `pinned`, with
    `torch.use_deterministic_algorithms(True, warn_only=True)` (PyTorch's
    own scatter-adds, e.g. the backward of `index_select` in the fusion's
    nearest resize, in their deterministic form where they have one);
  * `resumed`: a fresh model and state restored by `CheckpointManager`
    from the state saved before the step.

For each, against `replay_a`: the loss, `grad_norm`, and per tensor the
largest |difference| over the largest |value| of the updated master
weights and of the gradients (the 5 worst tensors named). Then
`msda_bwd` run twice on one captured launch's inputs (the first decoder
layer's call of the step): the largest relative difference of each
gradient. Prints one JSON line; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent


def rel_diffs(a: dict, b: dict) -> dict:
    """Per tensor max |a - b| / max(|b|, tiny)."""
    out = {}
    for k, t in b.items():
        d = (a[k].float() - t.float()).abs().max().item()
        out[k] = d / max(t.float().abs().max().item(), 1e-30)
    return out


def summary(diffs: dict) -> dict:
    worst = sorted(diffs.items(), key=lambda kv: -kv[1])
    return {"max": worst[0][1] if worst else 0.0,
            "tensors_differing": sum(1 for _, v in worst if v > 0),
            "tensors": len(worst),
            "worst": [[k, float(f"{v:.3e}")] for k, v in worst[:5]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_resume_drift: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from chip_smoke import synthetic_train_pack
    from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                              make_train_step)
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.ops import msda, msda_patch
    from trackformer_tpu_torch.utils.checkpoint import CheckpointManager
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    seed = args.seed
    cfg = FlagshipConfig.tpu_fast(dataset="mot_crowdhuman")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model, crit_cfg, _, track_cfg = build_model(cfg, "cuda", generator=gen,
                                                train=True)
    optimizer = make_optimizer(cfg, model)
    state = TrainState.create(model, optimizer)
    step_fn = make_train_step(model, crit_cfg, optimizer, track_cfg,
                              tracking=True, return_grads=True)
    gen.manual_seed(seed + 1)
    for step in range(2):
        state, _ = step_fn(state, synthetic_train_pack(cfg, seed, step), gen)
    pack = synthetic_train_pack(cfg, seed, 2)
    saved = {name: {k: v.clone() for k, v in getattr(state, name).items()}
             for name in ("params", "mu", "nu")}
    saved_step = state.step
    draws = gen.get_state()
    tmp = Path(tempfile.mkdtemp())
    CheckpointManager(tmp, save_interval=1).save(state, 2, {}, cfg)

    def restore_in_memory():
        with torch.no_grad():
            for name in ("params", "mu", "nu"):
                for k, t in getattr(state, name).items():
                    t.copy_(saved[name][k])
            for k, t in dict(model.named_parameters()).items():
                if k in saved["params"] and \
                        t.data_ptr() != state.params[k].data_ptr():
                    t.copy_(saved["params"][k])
        state.step = saved_step
        gen.set_state(draws)

    real_bwd = msda.msda_bwd_cuda
    recorded, captured = [], []

    def recording_bwd(*a, **kw):
        out = real_bwd(*a, **kw)
        recorded.append(tuple(t.clone() for t in out))
        if not captured and a[0].shape[1] != a[1].shape[1]:
            captured.append(tuple(x.clone() if torch.is_tensor(x) else x
                                  for x in a))
        return out

    def run(tag, fn=None):
        # the wrappers that launch the backward kernel look it up by name
        for mod in (msda, msda_patch):
            mod.msda_bwd_cuda = fn or real_bwd
        try:
            _, metrics = step_fn(state, pack, gen)
        finally:
            for mod in (msda, msda_patch):
                mod.msda_bwd_cuda = real_bwd
        torch.cuda.synchronize()
        return {"loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "params": {k: v.clone() for k, v in state.params.items()},
                "grads": {k: v.clone() for k, v in
                          metrics["_grads"].items()}}

    results = {}
    restore_in_memory()
    results["replay_a"] = run("replay_a", recording_bwd)
    pinned_outs = list(recorded)
    restore_in_memory()
    results["replay_b"] = run("replay_b")

    def pinned(*a, **kw):
        out = pinned_outs[pinned.i]
        pinned.i += 1
        return tuple(t.clone() for t in out)
    pinned.i = 0
    restore_in_memory()
    results["pinned"] = run("pinned", pinned)
    pinned.i = 0
    restore_in_memory()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        results["pinned_deterministic"] = run("pinned_deterministic", pinned)
    finally:
        torch.use_deterministic_algorithms(False)

    fresh, _, _, _ = build_model(cfg, "cuda", train=True)
    fresh_state = TrainState.create(fresh, make_optimizer(cfg, fresh))
    fresh_state, _ = CheckpointManager(tmp).restore(fresh_state, fresh)
    resume_fn = make_train_step(fresh, crit_cfg, make_optimizer(cfg, fresh),
                                track_cfg, tracking=True, return_grads=True)
    gen.set_state(draws)
    _, metrics = resume_fn(fresh_state, pack, gen)
    results["resumed"] = {
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "params": {k: v.clone() for k, v in fresh_state.params.items()},
        "grads": {k: v.clone() for k, v in metrics["_grads"].items()}}

    ref = results["replay_a"]
    report = {"device": smi, "msda_bwd_launches_a_step": len(pinned_outs)}
    for tag in ("replay_b", "pinned", "pinned_deterministic", "resumed"):
        r = results[tag]
        report[tag] = {
            "loss": r["loss"], "loss_rel_diff": abs(r["loss"] - ref["loss"])
            / abs(ref["loss"]),
            "grad_norm": r["grad_norm"],
            "grad_norm_rel_diff": abs(r["grad_norm"] - ref["grad_norm"])
            / abs(ref["grad_norm"]),
            "params": summary(rel_diffs(r["params"], ref["params"])),
            "grads": summary(rel_diffs(r["grads"], ref["grads"]))}
    report["replay_a_loss"] = ref["loss"]

    # msda_bwd twice on one captured launch's inputs
    a = real_bwd(*captured[0])
    b = real_bwd(*captured[0])
    report["msda_bwd_twice"] = {
        "call": {"items": captured[0][1].shape[0],
                 "queries": captured[0][3].shape[1],
                 "levels": len(captured[0][2]),
                 "channels": captured[0][1].shape[3],
                 "dtype": str(captured[0][1].dtype)},
        **{f"grad_{name}_max_rel_diff":
           (x.float() - y.float()).abs().max().item()
           / max(y.float().abs().max().item(), 1e-30)
           for name, x, y in zip(("value", "loc", "attn"), a, b)}}
    line = json.dumps(report)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2))
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
