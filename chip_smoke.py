#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (trackformer_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--frames 8] [--seed 0]

Phases, one line each:
  1. device: requires CUDA, prints `nvidia-smi` name and power limit;
  2. build: compiles the MSDA kernel from trackformer_tpu_torch/csrc for
     sm_90a;
  3. kernel: holds each MSDA wrapper's CUDA launch against the plain
     PyTorch version at the main path's shapes (encoder all levels,
     decoder eight levels, one decoder level), in float32 with TF32 off
     and in bfloat16, and times both;
  4. slice: builds the full-width flagship model (hidden 288, 6+6 layers,
     500 queries, 4 levels x 2 frames) with seeded random weights in
     bfloat16 and runs the port's `Tracker` over synthetic 800x1344
     frames, counting the MSDA launches of that run; then holds the same
     weights' float32 forward on the card against the CPU (plain MSDA) on
     a small image.
Then one JSON line with the kernels, and last the device line
`{"ok": true, "device": {...}}`. Any failed check exits non-zero before
that line; without a CUDA device the script exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# MSDA shapes of the flagship tracking step at the 800x1344 bucket
LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))
M, D, P = 8, 36, 4
DEC_QUERIES = 650  # 150 track slots + 500 object queries
# float32: the kernel and the plain version sum in different orders;
# bfloat16: the kernel rounds its float32 sum to bfloat16 once (half an
# ulp, at most 2^-8 relative) where the plain version returns float32
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -8)}
# small-image forward of the whole model, card (kernel) vs CPU (plain):
# float32 both, summed in different orders through ResNet-50 and 12 layers
SLICE_TOL = 2e-3


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn` on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def msda_inputs(shapes, lq, encoder, gen):
    """value, locations, weights on the card. Encoder queries sample near
    their own token (as a trained encoder does); decoder queries anywhere,
    some corners out of range."""
    dev = "cuda"
    s = sum(h * w for h, w in shapes)
    value = torch.randn(1, s, M, D, device=dev, generator=gen)
    nl = len(shapes)
    if encoder:
        refs = []
        for h, w in shapes:
            ys = (torch.arange(h, device=dev) + 0.5) / h
            xs = (torch.arange(w, device=dev) + 0.5) / w
            refs.append(torch.stack(torch.broadcast_tensors(
                xs[None, :], ys[:, None]), -1).reshape(-1, 2))
        ref = torch.cat(refs)[None, :, None, None, None, :]
        jitter = torch.randn(1, lq, M, nl, P, 2, device=dev, generator=gen)
        loc = ref + 0.03 * jitter
    else:
        loc = torch.rand(1, lq, M, nl, P, 2, device=dev, generator=gen)
        loc = loc * 1.1 - 0.05
    attn = torch.rand(1, lq, M, nl, P, device=dev, generator=gen)
    attn = attn / attn.sum((-2, -1), keepdim=True)
    return value, loc.contiguous(), attn


def kernel_phase(seed: int):
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import dense_level_pallas
    from trackformer_tpu_torch.ops.msda_patch import msda_patch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dec_levels = LEVELS * 2
    mid = LEVELS[1]
    cases = [
        ("encoder", LEVELS, sum(h * w for h, w in LEVELS), True,
         lambda v, lo, a: msda_patch(v, LEVELS, lo, a),
         lambda v, lo, a: msda.ms_deform_attn_plain(v, LEVELS, lo, a)),
        ("decoder", dec_levels, DEC_QUERIES, False,
         lambda v, lo, a: msda.ms_deform_attn(v, dec_levels, lo, a),
         lambda v, lo, a: msda.ms_deform_attn_plain(v, dec_levels, lo, a)),
        ("single_level", (mid,), DEC_QUERIES, False,
         lambda v, lo, a: dense_level_pallas(v, lo[:, :, :, 0],
                                             a[:, :, :, 0], *mid),
         lambda v, lo, a: msda.level_plain(v, lo[:, :, :, 0],
                                            a[:, :, :, 0], *mid)),
    ]
    results = {}
    for name, shapes, lq, encoder, kern, plain in cases:
        value, loc, attn = msda_inputs(shapes, lq, encoder, gen)
        for dtype in (torch.float32, torch.bfloat16):
            v = value.to(dtype)
            with torch.no_grad():
                got = kern(v, loc, attn).float().reshape(1, lq, M * D)
                torch.cuda.synchronize()
                want = plain(v, loc, attn).reshape(1, lq, M * D)
                err = (got - want).abs()
                atol, rtol = TOL[dtype]
                ok = bool((err <= atol + rtol * want.abs()).all())
                max_abs = err.max().item()
                max_rel = (err / want.abs().clamp(min=1e-3)).max().item()
                ms = time_ms(lambda: kern(v, loc, attn), 20)
                plain_ms = time_ms(lambda: plain(v, loc, attn), 5)
            phase("kernel", case=name, dtype=str(dtype).split(".")[-1],
                  lq=lq, levels=len(shapes), max_abs_err=f"{max_abs:.3e}",
                  max_rel_err=f"{max_rel:.3e}",
                  tol=f"{atol:g}+{rtol:g}*|ref|", ms=f"{ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}", ok=ok)
            check(ok, f"kernel {name} {dtype} out of tolerance: "
                      f"max abs err {max_abs}")
            results[(name, dtype)] = (max_abs, ms, plain_ms)
    return results


def synthetic_frames(n_frames: int, seed: int, hw, valid_hw):
    """A drifting random texture: one seeded base image, shifted a few
    pixels per frame, normalized like the eval transform's output, padded
    past `valid_hw` with zeros."""
    h, w = hw
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    base = torch.randn(1, 3, h // 8, w // 8, device="cuda", generator=gen)
    base = torch.nn.functional.interpolate(base, size=(h, w),
                                           mode="bilinear",
                                           align_corners=False)
    frames = []
    for t in range(n_frames):
        img = torch.roll(base, shifts=(3 * t, 5 * t), dims=(2, 3))
        img = img.permute(0, 2, 3, 1).contiguous()
        img[:, valid_hw[0]:] = 0
        img[:, :, valid_hw[1]:] = 0
        frames.append(img)
    return frames


def slice_phase(n_frames: int, seed: int):
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.structures import FrameBatch
    from trackformer_tpu_torch.tracking import Tracker
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    # the deployed tracking checkpoint (cfgs/track.yaml) is trained on
    # mot_crowdhuman: a 20-class head
    cfg = FlagshipConfig().replace(dataset="mot_crowdhuman")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model, postprocess = build_model(cfg, "cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    phase("slice", model="flagship", hidden=cfg.hidden_dim,
          layers=f"{cfg.enc_layers}+{cfg.dec_layers}",
          queries=cfg.num_queries, dtype=cfg.compute_dtype,
          params=n_params, build_s=f"{time.perf_counter() - t0:.2f}")

    # smoke-only override: random heads score every class alike near the
    # focal prior (0.01), and the tracker keeps only label 0 ("person");
    # a class-0 bias of 1 makes the random model a person detector scoring
    # mostly above the real thresholds, so tracks are born on frame 0 and
    # the track slots fill
    with torch.no_grad():
        for cls in model.class_embed:
            cls.bias[0] = 1.0
    phase("slice", override="class_embed.*.bias[0]=1 (smoke only)")
    tracker_cfg = {**cfg.tracker_cfg, "max_tracks": cfg.max_tracks}
    tracker = Tracker(model, postprocess, tracker_cfg, cfg.hidden_dim,
                      cfg.num_queries, overflow_boxes=cfg.overflow_boxes)
    bucket = cfg.image_bucket
    valid_hw = (750, 1333)         # 1080x1920 under the eval transform
    orig_size = torch.tensor([[1080, 1920]])
    frames = synthetic_frames(n_frames, seed, bucket, valid_hw)
    valid = torch.tensor([valid_hw])
    blobs = [{"batch": FrameBatch.from_images(f, valid),
              "orig_size": orig_size} for f in frames]
    torch.cuda.synchronize()

    msda.reset_launch_counts()
    frame_ms, live = [], []
    for blob in blobs:
        t0 = time.perf_counter()
        tracker.step(blob)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        live.append(int((tracker.state.active | tracker.state.inactive)
                        .sum()))
    counts = msda.launch_counts()
    total = sum(counts.values())

    st = tracker.state
    finite = all(bool(torch.isfinite(x).all())
                 for x in (st.boxes, st.scores, st.hs))
    results = tracker.get_results()
    n_entries = sum(len(v) for v in results.values())
    finite = finite and all(np.isfinite(e["bbox"]).all()
                            for v in results.values() for e in v.values())
    steady = statistics.median(frame_ms[1:]) if n_frames > 1 else None
    phase("slice", frames=n_frames, image=f"{bucket[0]}x{bucket[1]}",
          frame_ms="[" + ",".join(f"{t:.1f}" for t in frame_ms) + "]",
          steady_median_ms=f"{steady:.1f}" if steady else None,
          live_tracks=live, tracks=len(results), results=n_entries,
          reids=tracker.num_reids, msda_launches=total,
          launches=json.dumps(counts, separators=(",", ":")),
          finite=finite)
    check(total == 18 * n_frames,
          f"MSDA launches {total} != 18 x {n_frames} frames")
    check(counts["msda_patch"] == 12 * n_frames
          and counts["ms_deform_attn"] == 6 * n_frames,
          f"launches by wrapper {counts}")
    check(finite, "non-finite tracker outputs")
    check(len(results) > 0 and max(live) > 0, "no track was born")
    return counts, frame_ms, model


def reference_phase(model) -> float:
    """The same weights in float32: the forward on the card (CUDA kernel)
    against the forward on the CPU (plain MSDA) on a small image."""
    from trackformer_tpu_torch.structures import FrameBatch

    model = model.float()
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(1, 128, 192, 3).astype(np.float32))
    valid = torch.tensor([[120, 180]])
    outs = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            model.to(dev)
            outs[dev] = model(FrameBatch.from_images(img.to(dev), valid))[0]
    worst = 0.0
    for key in ("pred_logits", "pred_boxes", "hs_embed"):
        a, b = outs["cuda"][key].cpu(), outs["cpu"][key]
        check(bool(torch.isfinite(a).all()), f"non-finite {key}")
        err = ((a - b).abs() / (1.0 + b.abs())).max().item()
        worst = max(worst, err)
    phase("slice", reference="float32 card vs CPU, 128x192 image",
          max_scaled_err=f"{worst:.3e}", tol=SLICE_TOL,
          ok=worst <= SLICE_TOL)
    check(worst <= SLICE_TOL, f"card vs CPU forward differ by {worst}")
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "trackformer_tpu_torch" / "csrc" / "msda_fwd.cu").exists():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda import NVCC_FLAGS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    phase("device", name=json.dumps(name), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    msda.build_kernel()
    info = msda.kernel_build_info()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    phase("build", source="trackformer_tpu_torch/csrc/msda_fwd.cu",
          flags=json.dumps(" ".join(NVCC_FLAGS[:2])),
          seconds=f"{info['seconds']:.2f}", ptxas=json.dumps(regs))

    try:
        kres = kernel_phase(args.seed)
        counts, _, model = slice_phase(args.frames, args.seed)
        reference_phase(model)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    src = "trackformer_tpu_torch/csrc/msda_fwd.cu"
    bf16 = torch.bfloat16
    kernels = [
        {"name": "msda_fwd via msda_patch (encoder, all levels)",
         "route": "cuda", "source": src,
         "replaces": "trackformer_tpu/ops/msda_patch.py:108",
         "launches": counts["msda_patch"],
         "max_abs_err": kres[("encoder", bf16)][0],
         "ms": kres[("encoder", bf16)][1],
         "plain_ms": kres[("encoder", bf16)][2]},
        {"name": "msda_fwd via ms_deform_attn (decoder, 8 levels)",
         "route": "cuda", "source": src,
         "replaces": "trackformer_tpu/ops/msda_dense.py:216",
         "launches": counts["ms_deform_attn"],
         "max_abs_err": kres[("decoder", bf16)][0],
         "ms": kres[("decoder", bf16)][1],
         "plain_ms": kres[("decoder", bf16)][2]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
