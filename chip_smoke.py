#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (trackformer_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--frames 8] [--seed 0]

Phases, one line each:
  1. device: requires CUDA, prints `nvidia-smi` name and power limit;
  2. build: compiles both kernels from trackformer_tpu_torch/csrc for
     sm_90a, one nvcc each, started together; reports each one's seconds
     and registers;
  3. kernel msda: holds each MSDA wrapper's CUDA launch against the plain
     PyTorch version at the main paths' shapes (encoder all levels;
     decoder eight levels at B = 1 and at the lockstep step's B = 8; one
     decoder level), in float32 with TF32 off and in bfloat16, and times
     both;
  4. kernel window_layer: holds the fused window-layer kernel against its
     plain version at the fast mode's B = 1 and B = 8 shapes (380 and 3,040
     windows of 64 tokens, C = 288), both shift parities, with the key
     padding of the 750x1333 region in the 800x1344 bucket (fully-padded
     windows present), in float32 and bfloat16; times it, the plain
     version, a library composition (cuBLAS linears +
     scaled_dot_product_attention + layer_norm) and the weight packing;
  Times are CUDA-event medians over back-to-back calls (`time_ms`);
  5. slice exact: the full-width flagship model (hidden 288, 6+6 layers,
     500 queries, 4 levels x 2 frames, exact MSDA) with seeded random
     weights in bfloat16 through the port's `Tracker` over synthetic
     800x1344 frames, counting the kernel launches of that run; then the
     same weights' float32 forward on the card against the CPU;
  6. slice fast: the same in the TPU-fast mode (windowed encoder, cached
     memory): `Tracker` over the frames, 6 window-layer and 6 decoder MSDA
     launches per frame; then `BatchedTracker` over 8 sequences in
     lockstep; then the float32 forward, card against CPU, over two frames
     (the second reuses the first's cached memory).
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
BUCKET = (800, 1344)
VALID_HW = (750, 1333)         # a 1080x1920 video under the eval transform
M, D, P = 8, 36, 4
C, FF = 288, 1024
DEC_QUERIES = 650  # 150 track slots + 500 object queries
# float32: the kernel and the plain version sum in different orders;
# bfloat16: the kernel rounds its float32 sum to bfloat16 once (half an
# ulp, at most 2^-8 relative) where the plain version returns float32
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -8)}
# window layer, kernel against plain on the same inputs. float32 (TF32
# off): both round nowhere, they sum in different orders through five
# products, a softmax and two LayerNorms: 1e-4 + 1e-4 |ref|. bfloat16: both
# round at the same points, so the outputs differ where a sum in another
# order flips a rounding upstream; a LayerNorm output's error scales with
# its row, not with itself, so the bound is three bfloat16 ulps (2^-7
# relative) of max(1, |ref|)
def window_tol(dtype, ref: torch.Tensor):
    if dtype == torch.float32:
        return "1e-4+1e-4*|ref|", 1e-4 + 1e-4 * ref.abs()
    return "3*2^-7*max(1,|ref|)", 3 * 2.0 ** -7 * ref.abs().clamp(min=1.0)
# small-image forward of the whole model, card (kernels) vs CPU (plain):
# float32 both, summed in different orders through ResNet-50 and 12 layers
SLICE_TOL = 2e-3
# the card's published peaks (H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, reps: int, inner: int = 1) -> float:
    """Median milliseconds of `fn` on the current stream (CUDA events). With
    `inner` > 1 each timing spans that many calls back to back and is
    divided by it: the host queues the next call while the card runs this
    one, so the time is the card's, not the wrapper's host work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# calls per timing of a kernel, its plain version and its library call
INNER = 5


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    """(bound ms, what bounds it): the larger of the compulsory traffic
    over HBM bandwidth and the operations over the peak for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_counts():
    from trackformer_tpu_torch.ops import msda, window_attn
    return {**msda.launch_counts(), **window_attn.launch_counts()}


def reset_launch_counts() -> None:
    from trackformer_tpu_torch.ops import msda, window_attn
    msda.reset_launch_counts()
    window_attn.reset_launch_counts()


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

def msda_inputs(shapes, lq, encoder, gen, n=1):
    """value, locations, weights of `n` items on the card. Encoder queries
    sample near their own token (as a trained encoder does); decoder
    queries anywhere, some corners out of range."""
    dev = "cuda"
    s = sum(h * w for h, w in shapes)
    value = torch.randn(n, s, M, D, device=dev, generator=gen)
    nl = len(shapes)
    if encoder:
        refs = []
        for h, w in shapes:
            ys = (torch.arange(h, device=dev) + 0.5) / h
            xs = (torch.arange(w, device=dev) + 0.5) / w
            refs.append(torch.stack(torch.broadcast_tensors(
                xs[None, :], ys[:, None]), -1).reshape(-1, 2))
        ref = torch.cat(refs)[None, :, None, None, None, :]
        jitter = torch.randn(n, lq, M, nl, P, 2, device=dev, generator=gen)
        loc = ref + 0.03 * jitter
    else:
        loc = torch.rand(n, lq, M, nl, P, 2, device=dev, generator=gen)
        loc = loc * 1.1 - 0.05
    attn = torch.rand(n, lq, M, nl, P, device=dev, generator=gen)
    attn = attn / attn.sum((-2, -1), keepdim=True)
    return value, loc.contiguous(), attn


def msda_bound(value, loc, attn):
    """Each input read once, the output written once; 10 flops per sampled
    channel (4 bilinear corners and the weight) on the CUDA cores."""
    n, s, m, d = value.shape
    lq, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    es = value.element_size()
    n_bytes = (value.numel() * es + loc.numel() * 4 + attn.numel() * 4
               + n * lq * m * d * es)
    return bound(n_bytes, n * lq * m * l * p * d * 10, FP32_FLOPS)


def kernel_phase_msda(seed: int):
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import dense_level_pallas
    from trackformer_tpu_torch.ops.msda_patch import msda_patch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dec_levels = LEVELS * 2
    mid = LEVELS[1]
    # (name, levels, queries per item, encoder-like sampling, items,
    # kernel, plain); decoder_b8 is the lockstep step's decoder call
    cases = [
        ("encoder", LEVELS, sum(h * w for h, w in LEVELS), True, 1,
         lambda v, lo, a: msda_patch(v, LEVELS, lo, a),
         lambda v, lo, a: msda.ms_deform_attn_plain(v, LEVELS, lo, a)),
        ("decoder", dec_levels, DEC_QUERIES, False, 1,
         lambda v, lo, a: msda.ms_deform_attn(v, dec_levels, lo, a),
         lambda v, lo, a: msda.ms_deform_attn_plain(v, dec_levels, lo, a)),
        ("decoder_b8", dec_levels, DEC_QUERIES, False, 8,
         lambda v, lo, a: msda.ms_deform_attn(v, dec_levels, lo, a),
         lambda v, lo, a: msda.ms_deform_attn_plain(v, dec_levels, lo, a)),
        ("single_level", (mid,), DEC_QUERIES, False, 1,
         lambda v, lo, a: dense_level_pallas(v, lo[:, :, :, 0],
                                             a[:, :, :, 0], *mid),
         lambda v, lo, a: msda.level_plain(v, lo[:, :, :, 0],
                                            a[:, :, :, 0], *mid)),
    ]
    results = {}
    for name, shapes, lq, encoder, n, kern, plain in cases:
        value, loc, attn = msda_inputs(shapes, lq, encoder, gen, n)
        for dtype in (torch.float32, torch.bfloat16):
            v = value.to(dtype)
            with torch.no_grad():
                got = kern(v, loc, attn).float().reshape(n, lq, M * D)
                torch.cuda.synchronize()
                want = plain(v, loc, attn).reshape(n, lq, M * D)
                err = (got - want).abs()
                atol, rtol = TOL[dtype]
                ok = bool((err <= atol + rtol * want.abs()).all())
                max_abs = err.max().item()
                max_rel = (err / want.abs().clamp(min=1e-3)).max().item()
                ms = time_ms(lambda: kern(v, loc, attn), 20, INNER)
                plain_ms = time_ms(lambda: plain(v, loc, attn), 5, INNER)
            bound_ms, bound_by = msda_bound(v, loc, attn)
            phase("kernel", case=name, dtype=str(dtype).split(".")[-1],
                  items=n, lq=lq, levels=len(shapes),
                  max_abs_err=f"{max_abs:.3e}",
                  max_rel_err=f"{max_rel:.3e}",
                  tol=f"{atol:g}+{rtol:g}*|ref|", ms=f"{ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
                  bound_by=bound_by, ok=ok)
            check(ok, f"kernel {name} {dtype} out of tolerance: "
                      f"max abs err {max_abs}")
            results[(name, dtype)] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return results


def window_inputs(batch: int, shift: bool, dtype, gen):
    """The windowed layer's inputs at the fast mode's shapes: random tokens
    and positions, and the key padding that `window_context` makes from the
    level masks of the 750x1333 region in the 800x1344 bucket."""
    from trackformer_tpu_torch.models.backbone import downsample_mask
    from trackformer_tpu_torch.models.windowed_encoder import (
        pad_hw, window_context, window_partition)
    from trackformer_tpu_torch.structures import FrameBatch

    dev = "cuda"
    img = torch.zeros(batch, *BUCKET, 3, device=dev)
    mask = FrameBatch.from_images(
        img, torch.tensor([VALID_HW] * batch)).mask
    masks = [downsample_mask(mask, hw) for hw in LEVELS]
    poses = [torch.randn(batch, h, w, C, device=dev, generator=gen)
             for h, w in LEVELS]
    pw, kp = window_context(poses, masks, 8, shift, dtype)
    xw = torch.cat([window_partition(pad_hw(
        torch.randn(batch, h, w, C, device=dev, generator=gen), 8)[0], 8)
        for h, w in LEVELS]).to(dtype)
    # windows whose every slot lies in the padding (un-masked above)
    full_pad = 0
    for m in masks:
        mf = m[..., None].float()
        if shift:
            mf = torch.roll(mf, (-4, -4), (1, 2))
        mf = pad_hw(mf - 1.0, 8)[0] + 1.0
        full_pad += int((window_partition(mf, 8)[..., 0] > 0.5).all(1).sum())
    return xw, pw.contiguous(), kp.contiguous(), full_pad


def window_layer_module(gen, dtype):
    """A full-width `WindowedEncoderLayer` with seeded random weights:
    lecun-normal matrices, small random biases and norm affines, so every
    term of the layer carries signal."""
    from trackformer_tpu_torch.models.windowed_encoder import \
        WindowedEncoderLayer

    layer = WindowedEncoderLayer(C, M, FF, 8, shift=False).cuda()
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif "norm" in name and name.endswith("weight"):
                p.normal_(1.0, 0.1, generator=gen)
            else:
                p.normal_(0.0, 0.1, generator=gen)
    return layer.to(dtype).eval()


def window_layer_library(xw, pw, kp, layer):
    """The layer as a composition of library calls (cuBLAS linears,
    scaled_dot_product_attention with a float mask, layer_norm): a
    yardstick of time, never on the main path."""
    from torch.nn import functional as F

    nw, ws, c = xw.shape
    mha = layer.self_attn
    h = mha.num_heads
    wq, wk, wv = mha.in_proj_weight.chunk(3)
    bq, bk, bv = mha.in_proj_bias.chunk(3)
    q_in = xw + pw

    def heads(t):
        return t.view(nw, ws, h, c // h).transpose(1, 2)

    mask = torch.zeros(nw, 1, 1, ws, dtype=xw.dtype, device=xw.device)
    mask = mask.masked_fill(kp[:, None, None, :], torch.finfo(xw.dtype).min)
    a = F.scaled_dot_product_attention(
        heads(F.linear(q_in, wq, bq)), heads(F.linear(q_in, wk, bk)),
        heads(F.linear(xw, wv, bv)), attn_mask=mask)
    a = a.transpose(1, 2).reshape(nw, ws, c)
    x = F.layer_norm(xw + mha.out_proj(a), (c,), layer.norm1.weight,
                     layer.norm1.bias, layer.norm1.eps)
    f = layer.linear2(F.relu(layer.linear1(x)))
    return F.layer_norm(x + f, (c,), layer.norm2.weight, layer.norm2.bias,
                        layer.norm2.eps)


def window_bound(xw, kp, layer):
    """Each input (tokens, positions, key mask, weights) read once, the
    output written once; the products' flops on the tensor cores."""
    nw, ws, c = xw.shape
    rows = nw * ws
    es = xw.element_size()
    n_w = sum(p.numel() for p in layer.parameters())
    n_bytes = 3 * rows * c * es + kp.numel() + n_w * es
    flops = 2 * rows * c * (4 * c + 2 * FF) + 2 * 2 * nw * ws * ws * c
    return bound(n_bytes, flops, BF16_FLOPS)


def kernel_phase_window(seed: int):
    """The kernel against its plain version at the shapes of both fast
    paths (B = 1: 380 windows, B = 8: 3,040), float32 and bfloat16, both
    shift parities; times of the kernel, the plain version and the library
    composition in bfloat16 at shift 0. The wrapper packs a layer's weights
    once per dtype (`packed_weights`), so after the first call the kernel's
    time is that of one launch; the packing is timed apart."""
    from trackformer_tpu_torch.ops.window_attn import (
        fused_window_layer, pack_weights, window_layer_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # the plain version's bf16 products summed in float32 throughout, as
    # the kernel sums them
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    bf16 = torch.bfloat16
    errs, results = {}, {}
    try:
        for dtype in (torch.float32, bf16):
            layer = window_layer_module(gen, dtype)
            for batch in (1, 8):
                for shift in (False, True):
                    xw, pw, kp, full_pad = window_inputs(batch, shift, dtype,
                                                         gen)
                    with torch.no_grad():
                        got = fused_window_layer(xw, pw, kp, layer).float()
                        torch.cuda.synchronize()
                        want = window_layer_plain(xw, pw, kp, layer).float()
                    err = (got - want).abs()
                    tol_text, tol = window_tol(dtype, want)
                    finite = bool(torch.isfinite(got).all())
                    ok = bool((err <= tol).all()) and finite
                    max_abs = err.max().item()
                    worst = (err / tol).max().item()
                    phase("kernel", case="window_layer",
                          dtype=str(dtype).split(".")[-1], batch=batch,
                          shift=int(shift), windows=xw.shape[0],
                          fully_padded_windows=full_pad,
                          max_abs_err=f"{max_abs:.3e}",
                          err_over_tol=f"{worst:.3f}",
                          tol=tol_text, finite=finite, ok=ok)
                    check(full_pad > 0 or shift,
                          "no fully-padded window at shift 0")
                    check(ok, f"kernel window_layer {dtype} B={batch} shift "
                              f"{shift} out of tolerance: max abs err "
                              f"{max_abs}")
                    errs[(dtype, batch, shift)] = max_abs
                    if dtype != bf16 or shift:
                        continue
                    with torch.no_grad():
                        ms = time_ms(
                            lambda: fused_window_layer(xw, pw, kp, layer), 20,
                            INNER)
                        plain_ms = time_ms(
                            lambda: window_layer_plain(xw, pw, kp, layer), 10,
                            INNER)
                        lib_ms = time_ms(
                            lambda: window_layer_library(xw, pw, kp, layer),
                            10, INNER)
                        pack_ms = time_ms(lambda: pack_weights(layer, bf16),
                                          10, INNER)
                    bound_ms, bound_by = window_bound(xw, kp, layer)
                    phase("kernel", case="window_layer", dtype="bfloat16",
                          batch=batch, windows=xw.shape[0], ms=f"{ms:.4f}",
                          plain_ms=f"{plain_ms:.4f}",
                          library_composition_ms=f"{lib_ms:.4f}",
                          weight_packing_ms=f"{pack_ms:.4f}",
                          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
                    results[batch] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None,
                        library_composition_ms=lib_ms)
        for batch in results:
            results[batch]["max_abs_err"] = max(errs[(bf16, batch, False)],
                                                errs[(bf16, batch, True)])
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    return results


# --------------------------------------------------------------------------
# the main paths: exact mode, fast mode, fast mode batched
# --------------------------------------------------------------------------

def synthetic_frames(n_frames: int, seed: int, hw=BUCKET, valid_hw=VALID_HW):
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


def frame_blobs(n_frames: int, seed: int):
    from trackformer_tpu_torch.structures import FrameBatch

    valid = torch.tensor([VALID_HW])
    orig_size = torch.tensor([[1080, 1920]])
    return [{"batch": FrameBatch.from_images(f, valid),
             "orig_size": orig_size}
            for f in synthetic_frames(n_frames, seed)]


def smoke_model(cfg, seed: int, tag: str):
    """The full-width model with seeded random weights, made a person
    detector: random heads score every class alike near the focal prior
    (0.01), and the tracker keeps only label 0 ("person"); a class-0 bias
    of 1 (smoke only) scores most queries above the real thresholds, so
    tracks are born on frame 0 and the track slots fill."""
    from trackformer_tpu_torch.models import build_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model, postprocess = build_model(cfg, "cuda", generator=gen)
    with torch.no_grad():
        for cls in model.class_embed:
            cls.bias[0] = 1.0
    torch.cuda.synchronize()
    phase(tag, model="flagship", encoder=cfg.encoder_attention,
          cached_memory=cfg.cached_prev_memory, hidden=cfg.hidden_dim,
          layers=f"{cfg.enc_layers}+{cfg.dec_layers}",
          queries=cfg.num_queries, dtype=cfg.compute_dtype,
          params=sum(p.numel() for p in model.parameters()),
          build_s=f"{time.perf_counter() - t0:.2f}",
          override="class_embed.*.bias[0]=1 (smoke only)")
    return model, postprocess


def tracker_run(tag: str, cfg, model, postprocess, n_frames: int,
                seed: int, per_frame: dict):
    """The port's `Tracker` over synthetic frames; checks the launches of
    the run against `per_frame` launches per frame for every wrapper."""
    from trackformer_tpu_torch.tracking import Tracker

    tracker = Tracker(model, postprocess,
                      {**cfg.tracker_cfg, "max_tracks": cfg.max_tracks},
                      cfg.hidden_dim, cfg.num_queries,
                      overflow_boxes=cfg.overflow_boxes)
    blobs = frame_blobs(n_frames, seed)
    torch.cuda.synchronize()

    reset_launch_counts()
    frame_ms, live = [], []
    for blob in blobs:
        t0 = time.perf_counter()
        tracker.step(blob)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        live.append(int((tracker.state.active | tracker.state.inactive)
                        .sum()))
    counts = launch_counts()

    st = tracker.state
    finite = all(bool(torch.isfinite(x).all())
                 for x in (st.boxes, st.scores, st.hs))
    results = tracker.get_results()
    finite = finite and all(np.isfinite(e["bbox"]).all()
                            for v in results.values() for e in v.values())
    steady = statistics.median(frame_ms[1:]) if n_frames > 1 else None
    phase(tag, frames=n_frames, image=f"{BUCKET[0]}x{BUCKET[1]}",
          frame_ms="[" + ",".join(f"{t:.1f}" for t in frame_ms) + "]",
          steady_median_ms=f"{steady:.1f}" if steady else None,
          live_tracks=live, tracks=len(results),
          results=sum(len(v) for v in results.values()),
          reids=tracker.num_reids,
          launches=json.dumps(counts, separators=(",", ":")), finite=finite)
    for name, n in counts.items():
        want = per_frame.get(name, 0) * n_frames
        check(n == want, f"{tag}: {n} {name} launches, want {want}")
    check(finite, f"{tag}: non-finite tracker outputs")
    check(len(results) > 0 and max(live) > 0, f"{tag}: no track was born")
    return counts


def batched_run(cfg, model, postprocess, n_seqs: int, n_frames: int,
                seed: int):
    """`BatchedTracker` over `n_seqs` sequences in lockstep, each from its
    own seed; 6 + 6 launches per lockstep step."""
    from trackformer_tpu_torch.tracking import BatchedTracker

    tracker = BatchedTracker(model, postprocess,
                             {**cfg.tracker_cfg,
                              "max_tracks": cfg.max_tracks},
                             cfg.hidden_dim, cfg.num_queries,
                             overflow_boxes=cfg.overflow_boxes)
    seqs = [frame_blobs(n_frames, seed + 100 * (i + 1))
            for i in range(n_seqs)]
    step_end = []

    def logger(t, _):
        torch.cuda.synchronize()
        step_end.append(time.perf_counter())

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    results = tracker.run(seqs, logger=logger)
    counts = launch_counts()
    step_ms = np.diff([t0] + step_end) * 1e3
    steady = statistics.median(step_ms[1:])
    finite = all(np.isfinite(e["bbox"]).all() for r in results
                 for v in r.values() for e in v.values())
    live = [len([v for v in r.values() if n_frames - 1 in v])
            for r in results]
    phase("fast_batched", sequences=n_seqs, frames=n_frames,
          image=f"{BUCKET[0]}x{BUCKET[1]}",
          step_ms="[" + ",".join(f"{t:.1f}" for t in step_ms) + "]",
          steady_median_step_ms=f"{steady:.1f}",
          frames_per_s=f"{n_seqs * 1e3 / steady:.1f}",
          tracks_per_seq=[len(r) for r in results],
          live_at_last_frame=live,
          launches=json.dumps(counts, separators=(",", ":")), finite=finite)
    per_step = {"fused_window_layer": 6, "ms_deform_attn": 6}
    for name, n in counts.items():
        want = per_step.get(name, 0) * n_frames
        check(n == want, f"fast_batched: {n} {name} launches, want {want}")
    check(finite, "fast_batched: non-finite results")
    check(all(live), f"fast_batched: a sequence holds no track: {live}")
    return counts


def reference_run(tag: str, model, n_frames: int) -> float:
    """The same weights in float32: the forward on the card (CUDA kernels)
    against the forward on the CPU (plain versions) on a small image; from
    the second frame on, each device feeds its own previous frame's
    features back."""
    from trackformer_tpu_torch.structures import FrameBatch

    model = model.float()
    rng = np.random.RandomState(0)
    imgs = [torch.from_numpy(rng.randn(1, 128, 192, 3).astype(np.float32))
            for _ in range(n_frames)]
    valid = torch.tensor([[120, 180]])
    outs = {}
    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            model.to(dev)
            prev, outs[dev] = None, []
            for img in imgs:
                out, _, prev, _, _ = model(
                    FrameBatch.from_images(img.to(dev), valid), None, prev)
                outs[dev].append(out)
    worst = 0.0
    for a_out, b_out in zip(outs["cuda"], outs["cpu"]):
        for key in ("pred_logits", "pred_boxes", "hs_embed"):
            a, b = a_out[key].cpu(), b_out[key]
            check(bool(torch.isfinite(a).all()), f"{tag}: non-finite {key}")
            err = ((a - b).abs() / (1.0 + b.abs())).max().item()
            worst = max(worst, err)
    phase(tag, reference=f"float32 card vs CPU, 128x192 image, "
          f"{n_frames} frame(s)", max_scaled_err=f"{worst:.3e}",
          tol=SLICE_TOL, ok=worst <= SLICE_TOL)
    check(worst <= SLICE_TOL, f"{tag}: card vs CPU forward differ by "
                              f"{worst}")
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "trackformer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from trackformer_tpu_torch.ops import msda, window_attn
    from trackformer_tpu_torch.ops.cuda_build import NVCC_FLAGS, build_all
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    phase("device", name=json.dumps(name), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    build_all([msda.LIB, window_attn.LIB])
    for lib in (msda.LIB, window_attn.LIB):
        info = lib.info()
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        phase("build", source=info["source"],
              flags=json.dumps(" ".join(NVCC_FLAGS[:2])),
              seconds=f"{info['seconds']:.2f}", ptxas=json.dumps(regs))
    phase("build", both_seconds=f"{time.perf_counter() - t0:.2f}")

    # the deployed tracking checkpoint (cfgs/track.yaml) is trained on
    # mot_crowdhuman: a 20-class head
    exact_cfg = FlagshipConfig().replace(dataset="mot_crowdhuman")
    fast_cfg = FlagshipConfig.tpu_fast(dataset="mot_crowdhuman")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kmsda = kernel_phase_msda(args.seed)
        kwin = kernel_phase_window(args.seed)

        model, post = smoke_model(exact_cfg, args.seed, "exact")
        exact_counts = tracker_run("exact", exact_cfg, model, post,
                                   args.frames, args.seed,
                                   {"msda_patch": 12, "ms_deform_attn": 6})
        reference_run("exact", model, 1)
        del model

        model, post = smoke_model(fast_cfg, args.seed, "fast")
        fast_counts = tracker_run("fast", fast_cfg, model, post,
                                  args.frames, args.seed,
                                  {"fused_window_layer": 6,
                                   "ms_deform_attn": 6})
        batched_counts = batched_run(fast_cfg, model, post, 8, 6, args.seed)
        reference_run("fast", model, 2)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    msda_src = "trackformer_tpu_torch/csrc/msda_fwd.cu"
    win_src = "trackformer_tpu_torch/csrc/window_layer_fwd.cu"
    bf16 = torch.bfloat16
    kernels = [
        {"name": "msda_fwd via msda_patch (exact encoder, all levels)",
         "route": "cuda", "source": msda_src,
         "replaces": "trackformer_tpu/ops/msda_patch.py:108",
         "launches": exact_counts["msda_patch"],
         **kmsda[("encoder", bf16)]},
        {"name": "msda_fwd via ms_deform_attn (decoder, 8 levels, B = 1)",
         "route": "cuda", "source": msda_src,
         "replaces": "trackformer_tpu/ops/msda_dense.py:216",
         "launches": exact_counts["ms_deform_attn"]
         + fast_counts["ms_deform_attn"],
         **kmsda[("decoder", bf16)]},
        {"name": "msda_fwd via ms_deform_attn (decoder, 8 levels, B = 8)",
         "route": "cuda", "source": msda_src,
         "replaces": "trackformer_tpu/ops/msda_dense.py:216",
         "launches": batched_counts["ms_deform_attn"],
         **kmsda[("decoder_b8", bf16)]},
        {"name": "window_layer_fwd via fused_window_layer (fast encoder, "
                 "B = 1)",
         "route": "cuda", "source": win_src,
         "replaces": "trackformer_tpu/ops/window_attn.py:56",
         "launches": fast_counts["fused_window_layer"], **kwin[1]},
        {"name": "window_layer_fwd via fused_window_layer (fast encoder, "
                 "B = 8)",
         "route": "cuda", "source": win_src,
         "replaces": "trackformer_tpu/ops/window_attn.py:56",
         "launches": batched_counts["fused_window_layer"], **kwin[8]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
