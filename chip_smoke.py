#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (trackformer_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--frames 6] [--seed 0] [--phases a,b,...]

Phases, a few lines each (`--phases` runs a subset and then ends with a
last line marked "partial"; the kernels line needs all of them):
  device: requires CUDA, prints `nvidia-smi` name and power limit;
  build: compiles the eight kernel sources of trackformer_tpu_torch/csrc
     for sm_90a, one nvcc each, started together; reports each one's seconds
     and registers;
  msda: holds each MSDA wrapper's CUDA launch against the plain PyTorch
     version at the main paths' shapes (encoder all levels at B = 1 and at
     the training step's B = 2; decoder eight levels at B = 1, at the
     lockstep step's B = 8 and at the training step's 611 and 500 queries,
     B = 2; the six levels that `MSDA_DEC_SKIP` leaves to the gather kernel;
     one decoder level), in float32 with TF32 off and in bfloat16, and
     times both;
  window: holds the fused window-layer kernel against its plain version at
     the fast mode's B = 1 and B = 8 shapes (380 and 3,040 windows of 64
     tokens, C = 288), both shift parities, with the key padding of the
     750x1333 region in the 800x1344 bucket (fully-padded windows
     present), in float32 and bfloat16; times it, the plain version, a
     library composition (cuBLAS linears + scaled_dot_product_attention +
     layer_norm) and the weight packing;
  msda_bwd: holds the backward kernel's three gradients against autograd
     through the plain version at the training step's encoder call (N = 2,
     Lq = S = 22,323, 4 levels), its decoder call (N = 2, Lq = 611, 8
     levels) and route v2's four single-level encoder calls, float32 and
     bfloat16, with samples outside [0, 1]; then at two small calls that
     hold the scalar path (D = 6) and a plan with one level in shared
     memory and one not; prints each call's plan (`msda.bwd_plan`) and the
     reductions each design issues there; with `--old-msda-bwd PATH` (an
     earlier `csrc/msda_bwd.cu`, copied outside the package) times that
     design beside this one, in turns (`old_ms`);
  dense_v2: holds the block-skipping level kernel against the plain level
     on each of the four encoder levels, float32 and bfloat16, N = 1 and 2,
     with the initial offsets and with offsets six times as large, and its
     row bands against `v2_row_band`; times it, the plain version and the
     gather kernel on the same level; then the differentiable wrapper
     `dense_level_pallas_v2` on a slice of the value table, and the whole
     encoder call through route "v2" of `ms_deform_attn`: output and the
     three gradients against autograd through the plain version;
  dense_v4: holds the range-walking level kernel (TPU kernel v4 / v4p)
     against the plain level on each encoder level, N = 1 and 2, float32
     and bfloat16, with the initial offsets and with offsets six times as
     large, sorted in 64-column chunks (the call's one permutation, as route
     "v4" does) and unsorted at full width; on the decoder's 100x168 level
     with 650 (N = 1), 611 and 500 (N = 2) scattered queries; its walk
     bounds against `v4_ranges`, with the share of the level each walk
     reads; times beside the gather kernel's and the block-skipping
     kernel's on the same level; the differentiable wrappers' gradients;
     then the whole encoder call through route "v4" and the whole decoder
     call under `MSDA_DEC_SKIP`, output and gradients against the plain
     version, with their launch counts;
  dense_v3, gather_rows, patch_v6: the three kernels that no route of the
     JAX package reaches. Their path is the public op on the inputs of one
     real encoder MSDA call of the full-width exact model on a frame (the
     value after its projection, the layer's own locations and weights):
     `dense_level_pallas_v3` per level (windows against `v3_windows`, both
     the fitting and the full-width branch, also with offsets six times as
     large), `ms_deform_attn_pallas` (also at the decoder call's shape;
     timed beside torch.gather + multiply + sum, a library composition),
     `msda_patch_v6` (also N = 2 with samples pushed across the border);
     each against its plain version in float32 and bfloat16, with the
     wrappers' gradients where the op has them. These four kernels are also
     held at small shapes whose head rows align to 2 and to 4 bytes only
     (the staging words that D = 36 never takes);
  Times are CUDA-event medians over back-to-back calls (`time_ms`);
  exact: the full-width flagship model (hidden 288, 6+6 layers, 500
     queries, 4 levels x 2 frames, exact MSDA) with seeded random weights
     in bfloat16 through the port's `Tracker` over synthetic 800x1344
     frames, counting the kernel launches of that run; then the same
     weights' float32 forward on the card against the CPU; then the same
     tracker over fewer frames with `PALLAS_SKIP_IMPL=v4` (48 launches of
     kernel v4 and 6 decoder launches per frame) and with `MSDA_DEC_SKIP`
     (12 `msda_patch`, 12 of kernel v4 on the decoder's two 100x168 levels
     and 6 gather launches of the other six levels per frame);
  fast: the same in the TPU-fast mode (windowed encoder, cached memory):
     `Tracker` over the frames, 6 window-layer and 6 decoder MSDA launches
     per frame; then `BatchedTracker` over 8 sequences in lockstep; then
     the float32 forward, card against CPU, over two frames (the second
     reuses the first's cached memory);
  train: two-frame track-query training of the full-width exact-MSDA
     flagship in bfloat16, B = 2 frame pairs at 800x1344 with seeded
     synthetic boxes and track ids: 3 optimizer steps with the encoder on
     route "v5" (the gather kernel), then 2 on route "v2" (the
     block-skipping kernel, one launch per level) and 2 on route "v4" (the
     range-walking kernel likewise), each from the same state; finite
     losses, moved trainable and unmoved frozen weights, the launch
     counts of every step, step ms with its split by stage, peak memory;
     route v2's and route v4's first loss, first grad_norm and second loss
     against route v5's;
  train_reference: one float32 train step at 128x192, 2 + 2 layers, on the
     card (kernels) against the same step on the CPU (plain versions):
     loss, grad_norm and every gradient name by name, for two seeds, held
     against the CPU's float32 step and, ten times closer, its float64 step.
Then one JSON line with the kernels, each with the launches that the main
paths made at exactly its shape (it fails if a path launched a kernel at a
shape that no kernel phase held), and last the device line
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
# training shapes: two frame pairs per step; the decoder sees 500 object
# queries + 111 track-query slots (100 objects + 11 false positives)
TRAIN_BATCH = 2
TRAIN_DEC_QUERIES = 611
TRAIN_PREV_QUERIES = 500       # the previous frame's forward: no track query
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


def all_libs():
    """Every kernel library of the port."""
    from trackformer_tpu_torch.ops import (msda, msda_dense, msda_pallas,
                                           msda_patch, window_attn)
    return [msda.LIB, msda.BWD_LIB, msda_dense.V2_LIB, window_attn.LIB,
            msda_dense.V4_LIB, msda_dense.V3_LIB, msda_pallas.LIB,
            msda_patch.V6_LIB]


# MSDA launches of the main paths by shape, (count name, items, queries per
# item, levels) -> launches, summed over the paths' runs: each run adds what
# the wrappers counted between its reset and its read (`record_path`)
PATH_SHAPES: dict = {}


def record_path() -> None:
    from trackformer_tpu_torch.ops import msda
    for key, n in msda.launch_shapes().items():
        PATH_SHAPES[key] = PATH_SHAPES.get(key, 0) + n


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

def token_centres(shapes) -> torch.Tensor:
    """(S, 2) normalized (x, y) centre of every cell of every level, in
    raster order: the encoder's reference points on an unpadded image."""
    refs = []
    for h, w in shapes:
        ys = (torch.arange(h, device="cuda") + 0.5) / h
        xs = (torch.arange(w, device="cuda") + 0.5) / w
        refs.append(torch.stack(torch.broadcast_tensors(
            xs[None, :], ys[:, None]), -1).reshape(-1, 2))
    return torch.cat(refs)


def msda_inputs(shapes, lq, encoder, gen, n=1, ref_shapes=None):
    """value, locations, weights of `n` items on the card. Encoder queries
    (the tokens of `ref_shapes`, by default of `shapes`) sample near their
    own token (as a trained encoder does); decoder queries anywhere, some
    corners out of range."""
    dev = "cuda"
    s = sum(h * w for h, w in shapes)
    value = torch.randn(n, s, M, D, device=dev, generator=gen)
    nl = len(shapes)
    if encoder:
        ref = token_centres(ref_shapes or shapes)[None, :, None, None, None, :]
        jitter = torch.randn(n, lq, M, nl, P, 2, device=dev, generator=gen)
        loc = ref + 0.03 * jitter
    else:
        loc = torch.rand(n, lq, M, nl, P, 2, device=dev, generator=gen)
        loc = loc * 1.1 - 0.05
    attn = torch.rand(n, lq, M, nl, P, device=dev, generator=gen)
    attn = attn / attn.sum((-2, -1), keepdim=True)
    return value, loc.contiguous(), attn


def msda_bound(value, loc, attn, out_es=None):
    """Each input read once, the output written once (`out_es` bytes an
    element, by default the value's); 10 flops per sampled channel (4
    bilinear corners and the weight) on the CUDA cores."""
    n, s, m, d = value.shape
    lq, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    es = value.element_size()
    n_bytes = (value.numel() * es + loc.numel() * 4 + attn.numel() * 4
               + n * lq * m * d * (out_es or es))
    return bound(n_bytes, n * lq * m * l * p * d * 10, FP32_FLOPS)


def kernel_phase_msda(seed: int):
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import dense_level_pallas
    from trackformer_tpu_torch.ops.msda_patch import msda_patch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dec_levels = LEVELS * 2
    # what `MSDA_DEC_SKIP` leaves to the gather kernel of a decoder call
    rest_levels = LEVELS[1:] * 2
    mid = LEVELS[1]
    s_enc = sum(h * w for h, w in LEVELS)

    def enc_kernel(v, lo, a):
        return msda_patch(v, LEVELS, lo, a)

    def enc_plain(v, lo, a):
        return msda.ms_deform_attn_plain(v, LEVELS, lo, a)

    def dec_kernel(v, lo, a):
        return msda.ms_deform_attn(v, dec_levels, lo, a)

    def dec_plain(v, lo, a):
        return msda.ms_deform_attn_plain(v, dec_levels, lo, a)

    # (name, levels, queries per item, encoder-like sampling, items,
    # kernel, plain); decoder_b8 is the lockstep step's decoder call,
    # decoder_rest the six coarser levels of a decoder call, launched as
    # that route launches them: the float32 sums handed over unrounded,
    # encoder_train and decoder_train the training step's (two frame pairs,
    # 500 object queries + 111 track-query slots), decoder_train_prev that
    # of its previous-frame forward (the object queries alone)
    cases = [
        ("encoder", LEVELS, s_enc, True, 1, enc_kernel, enc_plain),
        ("decoder", dec_levels, DEC_QUERIES, False, 1, dec_kernel, dec_plain),
        ("decoder_b8", dec_levels, DEC_QUERIES, False, 8, dec_kernel,
         dec_plain),
        ("decoder_rest", rest_levels, DEC_QUERIES, False, 1,
         lambda v, lo, a: msda.msda_cuda(v, rest_levels, lo, a,
                                         "ms_deform_attn", out_f32=True),
         lambda v, lo, a: msda.ms_deform_attn_plain(v, rest_levels, lo, a)),
        ("encoder_train", LEVELS, s_enc, True, TRAIN_BATCH, enc_kernel,
         enc_plain),
        ("decoder_train", dec_levels, TRAIN_DEC_QUERIES, False, TRAIN_BATCH,
         dec_kernel, dec_plain),
        ("decoder_train_prev", dec_levels, TRAIN_PREV_QUERIES, False,
         TRAIN_BATCH, dec_kernel, dec_plain),
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
                got = kern(v, loc, attn)
                check(got.dtype == (torch.float32 if name == "decoder_rest"
                                    else dtype),
                      f"kernel {name} {dtype}: output in {got.dtype}")
                got = got.float().reshape(n, lq, M * D)
                torch.cuda.synchronize()
                want = plain(v, loc, attn).reshape(n, lq, M * D)
                err = (got - want).abs()
                atol, rtol = TOL[dtype]
                ok = bool((err <= atol + rtol * want.abs()).all())
                max_abs = err.max().item()
                max_rel = (err / want.abs().clamp(min=1e-3)).max().item()
                ms = time_ms(lambda: kern(v, loc, attn), 20, INNER)
                plain_ms = time_ms(lambda: plain(v, loc, attn), 5, INNER)
            bound_ms, bound_by = msda_bound(
                v, loc, attn, 4 if name == "decoder_rest" else None)
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


def grad_tol(dtype, ref: torch.Tensor, value_grad: bool) -> torch.Tensor:
    """Elementwise bound for a gradient of the backward kernel against
    autograd through the plain version. A gradient is a sum of signed terms
    in another order (float32 atomics for the value gradient), so its error
    scales with the terms, not the result: 1e-5 of max(1, max |ref|), plus
    1e-5 |ref|. In bfloat16 each side rounds its own float32 sum of the
    value gradient to bfloat16, so the two may land on neighbouring
    bfloat16 values, one ulp apart: up to 2^-7 |ref| there."""
    rel = 2.0 ** -7 if (value_grad and dtype == torch.bfloat16) else 1e-5
    return 1e-5 * max(1.0, ref.abs().max().item()) + rel * ref.abs()


def msda_bwd_bound(value, loc, attn, grad_es):
    """grad_out, value, locations and weights read once; the float32 value
    gradient read and written once; the other two gradients written once.
    Operations on the CUDA cores, as the kernel's arithmetic counts them.
    Per sampled channel 32: the bilinear sum of four corners 7 (a product
    and three multiply-adds), times the output gradient and summed 2; each
    of the x and y derivatives 7 (two differences, a product, a
    multiply-add, times the gradient and summed); the weight times the
    gradient 1, times each corner weight 4, and four atomic adds 4. Per
    sample, shared by its channels, 18: pixel coordinates 4, floors and
    fractions 4, their complements 2, four corner weights 4, scaling the
    location gradient 4."""
    n, s, m, d = value.shape
    lq, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    n_bytes = (n * lq * m * d * grad_es + value.numel() * value.element_size()
               + 2 * loc.numel() * 4 + 2 * attn.numel() * 4
               + 2 * value.numel() * 4)
    return bound(n_bytes, n * lq * m * l * p * (32 * d + 18), FP32_FLOPS)


# the parent design of the backward kernel, for an A/B beside the kernel
# (`--old-msda-bwd`): its library, built with the others, or None
OLD_BWD_LIB = None


def old_bwd_lib(path: str):
    """A `CudaLib` of an earlier `csrc/msda_bwd.cu` (a copy outside the
    package, for an A/B), with that design's C entry point: a warp per
    (query, head), its warps per block the last int."""
    import ctypes
    from trackformer_tpu_torch.ops.cuda_build import CudaLib
    return CudaLib(str(Path(path).resolve()), {"msda_bwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p])})


def raw_msda_bwd(fn, plan_args, grad_out, value, shapes, loc, attn):
    """`msda.msda_bwd_cuda`'s work through the C entry point `fn` of a
    backward library: the same zeroed float32 value gradient, launch and
    cast. `plan_args` are the entry point's arguments between the two
    dtype flags and the stream."""
    import ctypes
    n, s, m, d = value.shape
    lq, l = loc.shape[1], loc.shape[3]
    gv = torch.zeros(n, s, m, d, dtype=torch.float32, device=value.device)
    gl, ga = torch.empty_like(loc), torch.empty_like(attn)
    hw = (ctypes.c_int * (2 * l))(*[int(v) for pair in shapes for v in pair])
    rc = fn(grad_out.data_ptr(), value.data_ptr(), loc.data_ptr(),
            attn.data_ptr(), gv.data_ptr(), gl.data_ptr(), ga.data_ptr(), n, s,
            lq, m, l, loc.shape[4], d, hw, int(value.dtype == torch.bfloat16),
            int(grad_out.dtype == torch.bfloat16), *plan_args,
            torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"msda_bwd launch failed: cudaError {rc}")
    return gv.to(value.dtype), gl, ga


def old_msda_bwd(*args):
    """The earlier design (`--old-msda-bwd`), 8 warps a block as its
    wrapper launched it."""
    return raw_msda_bwd(OLD_BWD_LIB.load().msda_bwd, (8,), *args)


def direct_msda_bwd(grad_out, value, shapes, loc, attn):
    """`msda.msda_bwd_cuda` with no level summed in shared memory, every
    corner sent straight to global memory, in the blocks that a plan with
    no such level takes (the kernel's other half, timed beside its
    plan)."""
    from trackformer_tpu_torch.ops import msda
    n, _, m, d = value.shape
    lq, p = loc.shape[1], loc.shape[4]
    vector = msda.bwd_plan(n, lq, m, p, d, shapes).vector
    return raw_msda_bwd(
        msda.BWD_LIB.load().msda_bwd,
        (0, msda.bwd_queries(n, lq, m, msda.BWD_WAVES), 0, int(vector),
         msda.BWD_THREADS), grad_out, value, shapes, loc, attn)


def bwd_reductions(loc, shapes, plan, d):
    """Reductions into the value gradient at these samples, counted from
    the data as each design issues them: the earlier design one scalar
    atomic per in-range corner and channel; this one, per in-range corner
    of a level outside the plan, D / 4 vector (or D scalar) reductions, and
    per (block, cell) that a block's samples touched on a planned level the
    same at the flush (a piece that summed to zero is skipped there, so
    this is its upper bound), beside D shared-memory atomics per corner."""
    n, lq, m, _, p, _ = loc.shape
    per_row = d // 4 if plan.vector else d
    old = direct = flushed = shared = 0
    block = (torch.arange(n, device=loc.device)[:, None, None, None] * m
             + torch.arange(m, device=loc.device)[None, None, :, None]) \
        * (-(-lq // plan.queries)) \
        + (torch.arange(lq, device=loc.device) // plan.queries)[
            None, :, None, None]
    for lv, (h, w) in enumerate(shapes):
        x = (loc[:, :, :, lv, :, 0] * w - 0.5).floor().long()
        y = (loc[:, :, :, lv, :, 1] * h - 0.5).floor().long()
        keys = []                  # (block, cell) of each planned corner
        for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            ok = (x + cx >= 0) & (x + cx < w) & (y + cy >= 0) & (y + cy < h)
            hits = int(ok.sum())
            old += hits * d
            if lv not in plan.levels:
                direct += hits * per_row
                continue
            shared += hits * d
            cell = (y + cy) * w + (x + cx)
            keys.append(block.expand_as(cell)[ok] * (h * w) + cell[ok])
        if keys:
            flushed += int(torch.unique(torch.cat(keys)).numel()) * per_row
    return dict(old_scalar=old, direct=direct, flushed_at_most=flushed,
                shared_atomics=shared)


def kernel_phase_msda_bwd(seed: int):
    """The backward kernel's three gradients against autograd through
    `ms_deform_attn_plain`, at the training step's encoder call (N = 2,
    Lq = S = 22,323, 4 levels), its decoder call (N = 2, Lq = 611, 8
    levels) and the four single-level calls that route v2 makes per encoder
    layer (N = 2, all 22,323 tokens query one level), float32 and bfloat16,
    with samples outside [0, 1]; then two small calls: D = 6, whose head
    rows are not 16-byte aligned (the scalar path), and two levels of
    which one fits the shared-memory budget and one does not. Each case
    line shows the host's plan, the reductions each design issues at its
    samples and, with `--old-msda-bwd`, the earlier design's time beside
    this one's (`old_ms`), timed in turns."""
    from trackformer_tpu_torch.ops import msda

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    s_enc = sum(h * w for h, w in LEVELS)
    # (name, levels, queries, encoder-like, heads, channels, the plan's
    # levels and vector path where the case is there to hold them)
    cases = [("encoder", LEVELS, s_enc, True, M, D, None),
             ("decoder", LEVELS * 2, TRAIN_DEC_QUERIES, False, M, D, None)]
    cases += [(f"encoder_l{i}", (hw,), s_enc, True, M, D, None)
              for i, hw in enumerate(LEVELS)]
    cases += [("unaligned_d6", ((30, 40), (5, 7)), 3000, False, 2, 6,
               ((1,), False)),
              ("mixed_budget", ((120, 180), (20, 30)), 4000, False, M, D,
               ((1,), True))]
    results = {}
    for name, shapes, lq, encoder, m, d, want_plan in cases:
        if (m, d) == (M, D):
            value, loc, attn = msda_inputs(shapes, lq, encoder, gen,
                                           TRAIN_BATCH, ref_shapes=LEVELS)
        else:
            value = torch.randn(TRAIN_BATCH, sum(h * w for h, w in shapes),
                                m, d, device="cuda", generator=gen)
            loc = torch.rand(TRAIN_BATCH, lq, m, len(shapes), P, 2,
                             device="cuda", generator=gen) * 1.2 - 0.1
            attn = torch.rand(TRAIN_BATCH, lq, m, len(shapes), P,
                              device="cuda", generator=gen)
        if encoder:
            # push every 16th query's samples across the border
            loc[:, ::16] = loc[:, ::16] * 1.2 - 0.1
        outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
        plan = msda.bwd_plan(TRAIN_BATCH, lq, m, P, d, shapes)
        if want_plan is not None:
            check((plan.levels, plan.vector) == want_plan,
                  f"msda_bwd {name}: plan {plan}, want levels and vector "
                  f"{want_plan}")
        counts = bwd_reductions(loc, shapes, plan, d)
        g32 = torch.randn(TRAIN_BATCH, lq, m, d, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            v = value.to(dtype).requires_grad_(True)
            lo = loc.clone().requires_grad_(True)
            at = attn.clone().requires_grad_(True)
            g = g32.to(dtype)
            got = msda.msda_bwd_cuda(g, v.detach(), shapes, lo.detach(),
                                     at.detach())
            torch.cuda.synchronize()
            out = msda.ms_deform_attn_plain(v, shapes, lo, at).to(dtype)
            want = torch.autograd.grad(out, (v, lo, at), g,
                                       retain_graph=True)
            ok, errs = True, {}
            for key, a, b in zip(("value", "loc", "attn"), got, want):
                check(bool(torch.isfinite(a).all()),
                      f"msda_bwd {name} {dtype}: non-finite grad_{key}")
                err = (a.float() - b.float()).abs()
                tol = grad_tol(dtype, b.float(), key == "value")
                errs[key] = (err.max().item(), (err / tol).max().item())
                ok = ok and bool((err <= tol).all())
            args = (g, v.detach(), shapes, lo.detach(), at.detach())
            new_t, old_t, direct_t = [], [], []
            for _ in range(2):             # in turns: new, old, new, old
                new_t.append(time_ms(lambda: msda.msda_bwd_cuda(*args), 10,
                                     INNER))
                if OLD_BWD_LIB is not None:
                    old_t.append(time_ms(lambda: old_msda_bwd(*args), 10,
                                         INNER))
                if plan.levels:
                    direct_t.append(time_ms(lambda: direct_msda_bwd(*args),
                                            10, INNER))
            if plan.levels:
                gd = direct_msda_bwd(*args)
                for a, b in zip(gd, want):
                    check(bool((((a.float() - b.float()).abs()) <= grad_tol(
                        dtype, b.float(), a is gd[0])).all()),
                        f"msda_bwd {name} {dtype}: the direct launch is out "
                        f"of tolerance")
            ms = statistics.mean(new_t)
            old_ms = statistics.mean(old_t) if old_t else None
            direct_ms = statistics.mean(direct_t) if direct_t else ms
            plain_ms = time_ms(lambda: torch.autograd.grad(
                out, (v, lo, at), g, retain_graph=True), 3, 1)
            bound_ms, bound_by = msda_bwd_bound(v, lo, at, g.element_size())
            max_abs = max(e[0] for e in errs.values())
            phase("kernel", case=f"msda_bwd_{name}",
                  dtype=str(dtype).split(".")[-1], items=TRAIN_BATCH, lq=lq,
                  levels=len(shapes), heads=m, channels=d,
                  samples_outside=f"{outside:.3f}",
                  plan=json.dumps(plan._asdict(), separators=(",", ":")),
                  reductions=json.dumps(counts, separators=(",", ":")),
                  **{f"grad_{k}_max_abs_err": f"{e[0]:.3e}"
                     for k, e in errs.items()},
                  **{f"grad_{k}_err_over_tol": f"{e[1]:.3f}"
                     for k, e in errs.items()},
                  tol="1e-5*max(1,max|ref|)+1e-5*|ref| (bf16 grad_value: "
                      "2^-7*|ref|)",
                  ms=f"{ms:.4f}",
                  old_ms="not measured" if old_ms is None else
                  f"{old_ms:.4f}", direct_ms=f"{direct_ms:.4f}",
                  plain_backward_ms=f"{plain_ms:.4f}",
                  bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, ok=ok)
            check(ok, f"kernel msda_bwd {name} {dtype} out of tolerance: "
                      f"{errs}")
            check(outside > 0.01, f"msda_bwd {name}: no sample outside")
            results[(name, dtype)] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            del out, want, got
    return results


def encoder_level_inputs(level: int, n: int, scale: float, gen):
    """One level's inputs of the flagship encoder call: every token of all
    four levels queries level `level` at its own centre plus the model's
    initial sampling offsets (`msda_offset_bias`, normalized by (H, W) as
    the module does), times `scale`."""
    from trackformer_tpu_torch.models.factory import msda_offset_bias

    dev = "cuda"
    h, w = LEVELS[level]
    ref = token_centres(LEVELS)                             # (S, 2)
    off = torch.from_numpy(msda_offset_bias(M, len(LEVELS), P)).to(dev)
    off = off.view(M, len(LEVELS), P, 2)[:, level]          # (M, P, 2)
    off = scale * off / torch.tensor([h, w], device=dev, dtype=torch.float32)
    loc = (ref[None, :, None, None, :] + off[None, None]).expand(
        n, -1, -1, -1, -1).contiguous()
    value = torch.randn(n, h * w, M, D, device=dev, generator=gen)
    attn = torch.rand(n, ref.shape[0], M, P, device=dev, generator=gen)
    attn = attn / (len(LEVELS) * attn.sum(-1, keepdim=True))
    return value, loc, attn


def grads_against_plain(tag: str, dtype, kernel_fn, plain_fn, inputs, g,
                        **fields) -> None:
    """A differentiable wrapper against its plain version on the same
    inputs: the output within `TOL`, the gradients of the three `inputs`
    (value first)
    for the output gradient `g` within `grad_tol`. The plain version
    returns float32; `g` is rounded to `dtype` first, so both sides are
    given the same numbers."""
    g = g.to(dtype).float()
    got, want = [], []
    for fn, res in ((kernel_fn, got), (plain_fn, want)):
        leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = fn(*leaves)
        res.append(out.detach().float())
        res.extend(torch.autograd.grad(out, leaves, g.to(out.dtype)))
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    out_err = (got[0] - want[0].reshape(got[0].shape)).abs()
    out_tol = atol + rtol * want[0].reshape(got[0].shape).abs()
    ok = bool((out_err <= out_tol).all())
    errs = {"out": out_err.max().item()}
    for key, a, b in zip(("value", "loc", "attn"), got[1:], want[1:]):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{tag} {dtype}: grad_{key} shape or non-finite")
        err = (a.float() - b.float()).abs()
        tol = grad_tol(dtype, b.float(), key == "value")
        errs[key] = (err / tol).max().item()
        ok = ok and bool((err <= tol).all())
    phase("kernel", case=tag, dtype=str(dtype).split(".")[-1], **fields,
          out_max_abs_err=f"{errs['out']:.3e}",
          **{f"grad_{k}_err_over_tol": f"{errs[k]:.3f}"
             for k in ("value", "loc", "attn")}, ok=ok)
    check(ok, f"{tag} {dtype} {fields}: output or gradients out of "
              f"tolerance: {errs}")


def kernel_phase_dense_v2(seed: int):
    """The block-skipping kernel on each level of the flagship encoder call
    (Lq = 22,323 queries per item) against `level_plain`, float32 and
    bfloat16, N = 1 and 2, with the initial offsets (scale 1) and with
    offsets six times as large, so that a tile's band spans many rows; the
    kernel's own row bands against `v2_row_band`; times of the kernel, the
    plain version and the gather kernel on the same level (bfloat16, N = 2,
    scale 1). At N = 2 also the differentiable wrapper
    `dense_level_pallas_v2` as the training step calls it (the level's
    slice of the whole value table): output and the three gradients
    against autograd through `level_plain`; and at the end the whole
    encoder call through route "v2" of `ms_deform_attn` (four forward and
    four backward launches) against `ms_deform_attn_plain`."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import (
        V2_TQ, dense_level_pallas, dense_level_pallas_v2,
        dense_level_v2_fwd_cuda, v2_row_band)

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    bf16 = torch.bfloat16
    s_enc = sum(h * w for h, w in LEVELS)
    results = {}
    for level, (h, w) in enumerate(LEVELS):
        start = sum(a * b for a, b in LEVELS[:level])
        for n in (1, TRAIN_BATCH):
            for scale in (1.0, 6.0):
                value, loc, attn = encoder_level_inputs(level, n, scale, gen)
                lq = loc.shape[1]
                plain_band = v2_row_band(loc, h, V2_TQ)
                lo = plain_band[..., 0].clamp(min=0)
                hi = plain_band[..., 1].clamp(max=h - 1)
                rows = (hi - lo + 1).clamp(min=0).float()
                for dtype in (torch.float32, bf16):
                    v = value.to(dtype)
                    with torch.no_grad():
                        got, band = dense_level_v2_fwd_cuda(
                            v, loc, attn, h, w, return_band=True)
                        torch.cuda.synchronize()
                        want = msda.level_plain(v, loc, attn, h, w)
                    err = (got - want).abs()
                    atol, rtol = TOL[dtype]
                    ok = bool((err <= atol + rtol * want.abs()).all())
                    ok = ok and bool(torch.isfinite(got).all())
                    max_abs = err.max().item()
                    band_ok = (bool((band[..., 0] == lo).all())
                               and bool((band[..., 1] == hi).all()))
                    phase("kernel", case=f"dense_level_v2_l{level}",
                          level=f"{h}x{w}", dtype=str(dtype).split(".")[-1],
                          items=n, lq=lq, offset_scale=scale,
                          mean_band_rows=f"{rows.mean().item():.2f}",
                          max_band_rows=int(rows.max().item()),
                          rows_skipped=f"{1 - rows.mean().item() / h:.4f}",
                          max_abs_err=f"{max_abs:.3e}",
                          tol=f"{atol:g}+{rtol:g}*|ref|", band_ok=band_ok,
                          ok=ok)
                    check(ok, f"kernel dense_level_v2 level {level} {dtype} "
                              f"N={n} scale {scale} out of tolerance: max "
                              f"abs err {max_abs}")
                    check(band_ok, f"kernel dense_level_v2 level {level}: "
                                   "row bands differ from v2_row_band")
                    if n != TRAIN_BATCH:
                        continue
                    # the level's cells as a slice of the whole table
                    table = torch.zeros(n, s_enc, M, D, dtype=dtype,
                                        device="cuda")
                    table[:, start:start + h * w] = v
                    g = torch.randn(n, lq, M, D, device="cuda",
                                    generator=gen)
                    reset_launch_counts()
                    grads_against_plain(
                        f"dense_level_pallas_v2_grad_l{level}", dtype,
                        lambda t, lo_, at: dense_level_pallas_v2(
                            t[:, start:start + h * w], lo_, at, h, w),
                        lambda t, lo_, at: msda.level_plain(
                            t[:, start:start + h * w], lo_, at, h, w),
                        (table, loc, attn), g, items=n, offset_scale=scale)
                    shapes_seen = msda.launch_shapes()
                    check(shapes_seen == {
                        ("dense_level_pallas_v2", n, lq, ((h, w),)): 1,
                        ("msda_bwd", n, lq, ((h, w),)): 1},
                        f"dense_level_pallas_v2 level {level}: launched "
                        f"{shapes_seen}")
                    del table, g
                    if scale != 1.0 or dtype != bf16:
                        continue
                    with torch.no_grad():
                        ms = time_ms(lambda: dense_level_v2_fwd_cuda(
                            v, loc, attn, h, w), 20, INNER)
                        plain_ms = time_ms(lambda: msda.level_plain(
                            v, loc, attn, h, w), 5, INNER)
                        gather_ms = time_ms(lambda: dense_level_pallas(
                            v, loc, attn, h, w), 20, INNER)
                    n_bytes = (v.numel() * 2 + loc.numel() * 4
                               + attn.numel() * 4 + got.numel() * 4)
                    bound_ms, bound_by = bound(
                        n_bytes, 2 * n * lq * M * P * 4 * D, FP32_FLOPS)
                    phase("kernel", case=f"dense_level_v2_l{level}",
                          dtype="bfloat16", items=n, ms=f"{ms:.4f}",
                          plain_ms=f"{plain_ms:.4f}",
                          gather_kernel_ms=f"{gather_ms:.4f}",
                          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
                    results[level] = dict(
                        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, gather_kernel_ms=gather_ms)

    # the encoder call of the training step through the route switch
    value, loc, attn = msda_inputs(LEVELS, s_enc, True, gen, TRAIN_BATCH)
    loc[:, ::16] = loc[:, ::16] * 1.2 - 0.1
    g = torch.randn(TRAIN_BATCH, s_enc, M * D, device="cuda", generator=gen)
    saved_impl = msda.PALLAS_SKIP_IMPL
    try:
        msda.PALLAS_SKIP_IMPL = "v2"
        for dtype in (torch.float32, bf16):
            reset_launch_counts()
            grads_against_plain(
                "ms_deform_attn_route_v2_grad", dtype,
                lambda v, lo_, at: msda.ms_deform_attn(v, LEVELS, lo_, at),
                lambda v, lo_, at: msda.ms_deform_attn_plain(
                    v, LEVELS, lo_, at).flatten(2),
                (value.to(dtype), loc, attn), g, items=TRAIN_BATCH,
                lq=s_enc)
            counts = {k: v for k, v in msda.launch_counts().items() if v}
            check(counts == {"dense_level_pallas_v2": len(LEVELS),
                             "msda_bwd": len(LEVELS)},
                  f"route v2 encoder call launched {counts}")
    finally:
        msda.PALLAS_SKIP_IMPL = saved_impl
    return results


# --------------------------------------------------------------------------
# the tile-walking kernels of this slice: v4 / v4p, v3, gather-rows, v6
# --------------------------------------------------------------------------

def touched_value_rows(loc, shapes) -> int:
    """Distinct (item, head, cell) value rows that carry weight for these
    samples: loc (N, Lq, M, L, P, 2). What a kernel that skips has to read
    of the value table for this run's data."""
    n, _, m = loc.shape[:3]
    total = 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0] * w - 0.5).long()
        y0 = torch.floor(loc[:, :, :, lvl, :, 1] * h - 0.5).long()
        head = (torch.arange(n, device=loc.device)[:, None, None, None] * m
                + torch.arange(m, device=loc.device)[None, None, :, None])
        hit = torch.zeros(n * m * h * w + 1, dtype=torch.bool,
                          device=loc.device)
        for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            ix, iy = x0 + cx, y0 + cy
            ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            flat = torch.where(ok, head * (h * w) + iy * w + ix,
                               torch.full_like(ix, n * m * h * w))
            hit[flat.reshape(-1)] = True
        total += int(hit[:-1].sum())
    return total


def level_bound(value, loc, attn, h, w, extra_bytes: int = 0):
    """One level through a kernel that skips: the value rows that carry
    weight read once, locations and weights read once, the float32 output
    written once (+ `extra_bytes`, e.g. a permutation); 10 flops per
    sampled channel on the CUDA cores, as `msda_bound` counts them."""
    n, _, m, d = value.shape
    lq, p = loc.shape[1], loc.shape[3]
    rows = touched_value_rows(loc.unsqueeze(3), ((h, w),))
    n_bytes = (rows * d * value.element_size() + loc.numel() * 4
               + attn.numel() * 4 + n * lq * m * d * 4 + extra_bytes)
    return bound(n_bytes, n * lq * m * p * d * 10, FP32_FLOPS)


# Small shapes whose head rows align to 2 bytes (D = 5 bfloat16) and to 4
# (D = 6 bfloat16, D = 5 float32) only: the staging words the flagship's
# D = 36 never takes, with ragged tiles, three heads and three points
ODD_LEVELS = ((11, 17), (6, 9))
ODD_HEADS, ODD_POINTS, ODD_TQ = 3, 3, 16


def odd_shape_inputs(gen, d: int, shapes, lq: int):
    """value (2, S, 3, d), locations in [-0.1, 1.1] and weights for `lq`
    queries on `shapes`."""
    s = sum(h * w for h, w in shapes)
    value = torch.randn(2, s, ODD_HEADS, d, device="cuda", generator=gen)
    loc = torch.rand(2, lq, ODD_HEADS, len(shapes), ODD_POINTS, 2,
                     device="cuda", generator=gen) * 1.2 - 0.1
    attn = torch.rand(2, lq, ODD_HEADS, len(shapes), ODD_POINTS,
                      device="cuda", generator=gen)
    return value, loc, attn / attn.sum((-2, -1), keepdim=True)


def held_against_plain(tag: str, dtype, got, want, **fields) -> float:
    """A kernel's float32 output against its plain version's within `TOL`;
    prints the reading, fails the run if it is out -> max abs error."""
    err = (got.float() - want.float().reshape(got.shape)).abs()
    atol, rtol = TOL[dtype]
    ok = bool((err <= atol + rtol * want.reshape(got.shape).abs()).all())
    ok = ok and bool(torch.isfinite(got).all())
    max_abs = err.max().item()
    phase("kernel", case=tag, dtype=str(dtype).split(".")[-1], **fields,
          max_abs_err=f"{max_abs:.3e}", tol=f"{atol:g}+{rtol:g}*|ref|", ok=ok)
    check(ok, f"kernel {tag} {dtype} {fields} out of tolerance: max abs err "
              f"{max_abs}")
    return max_abs


def kernel_phase_dense_v4(seed: int):
    """The range-walking kernel (module docstring). -> results by
    ("enc", N, level) and ("dec", N, Lq), each timed in bfloat16 with the
    initial offsets, sorted in chunks as the routes launch it."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import (
        V2_TQ, dense_level_pallas, dense_level_pallas_v4,
        dense_level_pallas_v4p, dense_level_v2_fwd_cuda,
        dense_level_v4_fwd_cuda, spatial_sort_perm, v4_ranges)

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    bf16 = torch.bfloat16
    cw = msda.PALLAS_V4_CW
    s_enc = sum(h * w for h, w in LEVELS)
    results = {}

    def held(tag, value, loc, attn, h, w, perm, chunk, **fields):
        """Both dtypes against the plain level, the kernel's walk bounds
        against `v4_ranges` -> bfloat16 max abs error."""
        want_r = v4_ranges(loc, h, w, V2_TQ, chunk, perm)
        cells = ((want_r[..., 1] - want_r[..., 0] + 1).clamp(min=0)
                 * (want_r[..., 3] - want_r[..., 2] + 1)).float()
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            with torch.no_grad():
                got, ranges = dense_level_v4_fwd_cuda(
                    v, loc, attn, h, w, perm=perm, cw=chunk,
                    return_ranges=True)
                torch.cuda.synchronize()
                want = msda.level_plain(v, loc, attn, h, w)
            ranges_ok = bool((ranges.long() == want_r).all())
            err = held_against_plain(
                tag, dtype, got, want, level=f"{h}x{w}", items=loc.shape[0],
                lq=loc.shape[1], **fields,
                walk="sorted, chunks of %d" % chunk if chunk else
                "raster, full width",
                mean_cells_walked=f"{cells.mean().item():.0f}",
                level_skipped=f"{1 - cells.mean().item() / (h * w):.4f}",
                ranges_ok=ranges_ok)
            check(ranges_ok, f"kernel {tag}: walk bounds differ from "
                             "v4_ranges")
        return err

    def timed(tag, v, loc, attn, h, w, perm, err):
        with torch.no_grad():
            ms = time_ms(lambda: dense_level_v4_fwd_cuda(
                v, loc, attn, h, w, perm=perm, cw=cw), 20, INNER)
            rows_ms = time_ms(lambda: dense_level_v4_fwd_cuda(
                v, loc, attn, h, w), 20, INNER)
            plain_ms = time_ms(lambda: msda.level_plain(v, loc, attn, h, w),
                               5, INNER)
            gather_ms = time_ms(lambda: dense_level_pallas(
                v, loc, attn, h, w), 20, INNER)
            v2_ms = time_ms(lambda: dense_level_v2_fwd_cuda(
                v, loc, attn, h, w), 20, INNER)
            sort_ms = time_ms(lambda: spatial_sort_perm(loc, h, w), 10, INNER)
        bound_ms, bound_by = level_bound(v, loc, attn, h, w, perm.numel() * 8)
        phase("kernel", case=tag, dtype="bfloat16", items=loc.shape[0],
              lq=loc.shape[1], ms=f"{ms:.4f}",
              unsorted_full_width_ms=f"{rows_ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", gather_kernel_ms=f"{gather_ms:.4f}",
              block_skipping_kernel_ms=f"{v2_ms:.4f}",
              spatial_sort_ms=f"{sort_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
              bound_by=bound_by)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    gather_kernel_ms=gather_ms, block_skipping_kernel_ms=v2_ms,
                    unsorted_full_width_ms=rows_ms)

    # the encoder's call: every token queries every level
    for n in (1, TRAIN_BATCH):
        for scale in (1.0, 6.0):
            # the call's one permutation, from level 0's locations
            perm = spatial_sort_perm(
                encoder_level_inputs(0, n, scale, gen)[1], *LEVELS[0])
            for level, (h, w) in enumerate(LEVELS):
                start = sum(a * b for a, b in LEVELS[:level])
                value, loc, attn = encoder_level_inputs(level, n, scale, gen)
                tag = f"dense_level_v4_l{level}"
                err = held(tag, value, loc, attn, h, w, perm, cw,
                           offset_scale=scale)
                held(tag, value, loc, attn, h, w, None, None,
                     offset_scale=scale)
                if scale == 1.0:
                    results[("enc", n, level)] = timed(
                        tag, value.to(bf16), loc, attn, h, w, perm, err)
                if n != TRAIN_BATCH:
                    continue
                # the wrappers as the training step calls them: the level's
                # cells as a slice of the whole table
                g = torch.randn(n, s_enc, M, D, device="cuda", generator=gen)
                for dtype in (torch.float32, bf16):
                    table = torch.zeros(n, s_enc, M, D, dtype=dtype,
                                        device="cuda")
                    table[:, start:start + h * w] = value.to(dtype)
                    wrappers = [("dense_level_pallas_v4p_grad",
                                 lambda t, lo_, at: dense_level_pallas_v4p(
                                     t[:, start:start + h * w], lo_, at, perm,
                                     h, w, cw))]
                    if scale == 1.0:
                        wrappers.append((
                            "dense_level_pallas_v4_grad",
                            lambda t, lo_, at: dense_level_pallas_v4(
                                t[:, start:start + h * w], lo_, at, h, w)))
                    for name, fn in wrappers:
                        reset_launch_counts()
                        grads_against_plain(
                            f"{name}_l{level}", dtype, fn,
                            lambda t, lo_, at: msda.level_plain(
                                t[:, start:start + h * w], lo_, at, h, w),
                            (table, loc, attn), g, items=n,
                            offset_scale=scale)
                        seen = msda.launch_shapes()
                        check(seen == {
                            ("dense_level_pallas_v4", n, s_enc, ((h, w),)): 1,
                            ("msda_bwd", n, s_enc, ((h, w),)): 1},
                            f"{name} level {level}: launched {seen}")
                    del table

    # the decoder's call on a frame's finest level: scattered queries
    h, w = LEVELS[0]
    for n, lq in ((1, DEC_QUERIES), (TRAIN_BATCH, TRAIN_DEC_QUERIES),
                  (TRAIN_BATCH, TRAIN_PREV_QUERIES)):
        value, loc, attn = msda_inputs((LEVELS[0],), lq, False, gen, n)
        loc, attn = loc[:, :, :, 0].contiguous(), attn[:, :, :, 0].contiguous()
        perm = spatial_sort_perm(loc, h, w)
        err = held("dense_level_v4_decoder", value, loc, attn, h, w, perm, cw)
        results[("dec", n, lq)] = timed("dense_level_v4_decoder",
                                        value.to(bf16), loc, attn, h, w, perm,
                                        err)
        g = torch.randn(n, lq, M, D, device="cuda", generator=gen)
        for dtype in (torch.float32, bf16):
            grads_against_plain(
                "dense_level_pallas_v4p_grad_decoder", dtype,
                lambda v, lo_, at: dense_level_pallas_v4p(v, lo_, at, perm, h,
                                                          w, cw),
                lambda v, lo_, at: msda.level_plain(v, lo_, at, h, w),
                (value.to(dtype), loc, attn), g, items=n, lq=lq)

    # the other staging words (`ODD_LEVELS`)
    h, w = ODD_LEVELS[0]
    for d in (5, 6):
        value, loc, attn = odd_shape_inputs(gen, d, ODD_LEVELS[:1], 70)
        loc, attn = loc[:, :, :, 0].contiguous(), attn[:, :, :, 0].contiguous()
        perm = spatial_sort_perm(loc, h, w)
        want_r = v4_ranges(loc, h, w, ODD_TQ, 8, perm)
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            got, ranges = dense_level_v4_fwd_cuda(
                v, loc, attn, h, w, perm=perm, cw=8, tq=ODD_TQ,
                return_ranges=True)
            held_against_plain("dense_level_v4_odd_shape", dtype, got,
                               msda.level_plain(v, loc, attn, h, w), d=d,
                               ranges_ok=bool((ranges.long() == want_r).all()))
            check(bool((ranges.long() == want_r).all()),
                  "dense_level_v4 odd shape: walk bounds")

    # whole calls through the route switches
    value, loc, attn = msda_inputs(LEVELS, s_enc, True, gen, TRAIN_BATCH)
    loc[:, ::16] = loc[:, ::16] * 1.2 - 0.1
    g = torch.randn(TRAIN_BATCH, s_enc, M * D, device="cuda", generator=gen)
    saved = (msda.PALLAS_SKIP_IMPL, msda.PALLAS_V4_SORT, msda.MSDA_DEC_SKIP)
    try:
        msda.PALLAS_SKIP_IMPL = "v4"
        for sort in (True, False):
            msda.PALLAS_V4_SORT = sort
            for dtype in (torch.float32, bf16):
                reset_launch_counts()
                grads_against_plain(
                    "ms_deform_attn_route_v4_grad", dtype,
                    lambda v, lo_, at: msda.ms_deform_attn(v, LEVELS, lo_, at),
                    lambda v, lo_, at: msda.ms_deform_attn_plain(
                        v, LEVELS, lo_, at).flatten(2),
                    (value.to(dtype), loc, attn), g, items=TRAIN_BATCH,
                    lq=s_enc, sorted=sort)
                counts = {k: v for k, v in msda.launch_counts().items() if v}
                check(counts == {"dense_level_pallas_v4": len(LEVELS),
                                 "msda_bwd": len(LEVELS)},
                      f"route v4 encoder call launched {counts}")
        msda.PALLAS_SKIP_IMPL, msda.PALLAS_V4_SORT = saved[:2]
        msda.MSDA_DEC_SKIP = True
        dec_levels = LEVELS * 2
        value, loc, attn = msda_inputs(dec_levels, DEC_QUERIES, False, gen, 1)
        g = torch.randn(1, DEC_QUERIES, M * D, device="cuda", generator=gen)
        for dtype in (torch.float32, bf16):
            reset_launch_counts()
            grads_against_plain(
                "ms_deform_attn_dec_skip_grad", dtype,
                lambda v, lo_, at: msda.ms_deform_attn(v, dec_levels, lo_, at),
                lambda v, lo_, at: msda.ms_deform_attn_plain(
                    v, dec_levels, lo_, at).flatten(2),
                (value.to(dtype), loc, attn), g, items=1, lq=DEC_QUERIES)
            counts = {k: v for k, v in msda.launch_counts().items() if v}
            check(counts == {"dense_level_pallas_v4": 2, "ms_deform_attn": 1,
                             "msda_bwd": 3},
                  f"MSDA_DEC_SKIP decoder call launched {counts}")
    finally:
        (msda.PALLAS_SKIP_IMPL, msda.PALLAS_V4_SORT,
         msda.MSDA_DEC_SKIP) = saved
    return results


def captured_encoder_call(seed: int):
    """The inputs of one real encoder MSDA call of the full-width exact
    model on a frame: (value (1, S, M, D) after the value projection, in
    the model's bfloat16; the layer's own locations and weights, float32).
    The first layer's call on the first synthetic frame."""
    from trackformer_tpu_torch.models import deformable_transformer
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    cfg = FlagshipConfig().replace(dataset="mot_crowdhuman")
    model, _ = smoke_model(cfg, seed, "captured_call")
    real = deformable_transformer.ms_deform_attn
    seen = []

    def recorder(value, spatial_shapes, loc, attn):
        if not seen and loc.shape[1] == value.shape[1]:
            seen.append((value.detach().clone(), loc.detach().clone(),
                         attn.detach().clone(),
                         tuple(tuple(hw) for hw in spatial_shapes)))
        return real(value, spatial_shapes, loc, attn)

    deformable_transformer.ms_deform_attn = recorder
    try:
        with torch.inference_mode():
            model(frame_blobs(1, seed)[0]["batch"], None, None)
    finally:
        deformable_transformer.ms_deform_attn = real
    check(len(seen) == 1, "no encoder MSDA call was seen")
    value, loc, attn, shapes = seen[0]
    check(shapes == LEVELS and value.shape == (1, loc.shape[1], M, D)
          and value.dtype == torch.bfloat16,
          f"captured call: levels {shapes}, value {tuple(value.shape)} "
          f"{value.dtype}")
    # out of inference mode, so that the gradient checks can use them
    value, loc, attn = (x.clone() for x in (value, loc, attn))
    outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
    phase("captured_call", call="encoder layer 0, frame 0", items=1,
          lq=loc.shape[1], levels=len(shapes), dtype="bfloat16",
          samples_outside=f"{outside:.4f}",
          attn_min=f"{attn.min().item():.4f}",
          attn_max=f"{attn.max().item():.4f}")
    del model
    return value, loc.float().contiguous(), attn.float().contiguous()


def kernel_phase_dense_v3(seed: int, captured):
    """The sorted, x-windowed kernel: the public op on each level of the
    captured encoder call (its path), its windows against `v3_windows`;
    the same with offsets six times as large, N = 2, where tiles do not
    fit; and with a window of one column, which no tile fits, so that every
    tile takes the full width. -> results by level."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import (
        V2_TQ, V3_CW, dense_level_pallas, dense_level_pallas_v3,
        dense_level_v2_fwd_cuda, dense_level_v3_fwd_cuda, spatial_sort_perm,
        v3_windows)

    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    bf16 = torch.bfloat16
    value_all, loc_all, attn_all = captured
    s_enc = loc_all.shape[1]
    results, fit_share = {}, []
    for level, (h, w) in enumerate(LEVELS):
        start = sum(a * b for a, b in LEVELS[:level])
        cases = [("captured call", value_all[:, start:start + h * w].float(),
                  loc_all[:, :, :, level].contiguous(),
                  attn_all[:, :, :, level].contiguous())]
        cases.append(("offsets x6, N=2",
                      *encoder_level_inputs(level, TRAIN_BATCH, 6.0, gen)))
        for what, value, loc, attn in cases:
            perm = spatial_sort_perm(loc, h, w)
            want_w = v3_windows(loc, h, w, perm, V2_TQ, V3_CW)
            fits = want_w[..., 3].float().mean().item()
            fit_share.append(fits)
            for dtype in (torch.float32, bf16):
                v = value.to(dtype).contiguous()
                with torch.no_grad():
                    got, windows = dense_level_v3_fwd_cuda(
                        v, loc, attn, h, w, return_windows=True)
                    full, none_fit = dense_level_v3_fwd_cuda(
                        v, loc, attn, h, w, cw=1, return_windows=True)
                    torch.cuda.synchronize()
                    want = msda.level_plain(v, loc, attn, h, w)
                windows_ok = bool((windows.long() == want_w).all())
                err = held_against_plain(
                    f"dense_level_v3_l{level}", dtype, got, want,
                    level=f"{h}x{w}", inputs=json.dumps(what),
                    items=loc.shape[0], tiles_that_fit=f"{fits:.4f}",
                    windows_ok=windows_ok)
                held_against_plain(
                    f"dense_level_v3_l{level}", dtype, full, want,
                    level=f"{h}x{w}", inputs=json.dumps(what),
                    branch="cw=1: every tile on the full width",
                    tiles_that_fit=int(none_fit[..., 3].sum().item()))
                check(int(none_fit[..., 3].sum().item()) == 0,
                      f"dense_level_v3 level {level}: a tile fits one column")
                check(windows_ok, f"kernel dense_level_v3 level {level}: "
                                  "windows differ from v3_windows")
            if what != "captured call":
                continue
            # the path: the public op on the captured call, counted
            v = value.to(bf16).contiguous()
            reset_launch_counts()
            with torch.no_grad():
                out = dense_level_pallas_v3(v, loc, attn, h, w)
            check(out.shape == (1, s_enc, M, D)
                  and bool(torch.isfinite(out).all()),
                  "dense_level_pallas_v3: output")
            record_path()
            g = torch.randn(1, s_enc, M, D, device="cuda", generator=gen)
            for dtype in (torch.float32, bf16):
                grads_against_plain(
                    f"dense_level_pallas_v3_grad_l{level}", dtype,
                    lambda v_, lo_, at: dense_level_pallas_v3(v_, lo_, at, h,
                                                              w),
                    lambda v_, lo_, at: msda.level_plain(v_, lo_, at, h, w),
                    (value.to(dtype), loc, attn), g, items=1)
            with torch.no_grad():
                ms = time_ms(lambda: dense_level_v3_fwd_cuda(
                    v, loc, attn, h, w, perm=perm), 20, INNER)
                with_sort_ms = time_ms(lambda: dense_level_v3_fwd_cuda(
                    v, loc, attn, h, w), 20, INNER)
                full_ms = time_ms(lambda: dense_level_v3_fwd_cuda(
                    v, loc, attn, h, w, perm=perm, cw=1), 20, INNER)
                plain_ms = time_ms(lambda: msda.level_plain(
                    v, loc, attn, h, w), 5, INNER)
                gather_ms = time_ms(lambda: dense_level_pallas(
                    v, loc, attn, h, w), 20, INNER)
                v2_ms = time_ms(lambda: dense_level_v2_fwd_cuda(
                    v, loc, attn, h, w), 20, INNER)
            bound_ms, bound_by = level_bound(v, loc, attn, h, w)
            phase("kernel", case=f"dense_level_v3_l{level}",
                  dtype="bfloat16", items=1, lq=s_enc, ms=f"{with_sort_ms:.4f}",
                  kernel_alone_ms=f"{ms:.4f}",
                  every_tile_full_width_ms=f"{full_ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}",
                  gather_kernel_ms=f"{gather_ms:.4f}",
                  block_skipping_kernel_ms=f"{v2_ms:.4f}",
                  bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
            results[level] = dict(
                max_abs_err=err, ms=with_sort_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                kernel_alone_ms=ms, gather_kernel_ms=gather_ms,
                block_skipping_kernel_ms=v2_ms)
    h, w = ODD_LEVELS[0]
    for d in (5, 6):                # the other staging words
        value, loc, attn = odd_shape_inputs(gen, d, ODD_LEVELS[:1], 70)
        loc, attn = loc[:, :, :, 0].contiguous(), attn[:, :, :, 0].contiguous()
        perm = spatial_sort_perm(loc, h, w)
        want_w = v3_windows(loc, h, w, perm, ODD_TQ, 8)
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            got, windows = dense_level_v3_fwd_cuda(
                v, loc, attn, h, w, perm=perm, cw=8, tq=ODD_TQ,
                return_windows=True)
            held_against_plain(
                "dense_level_v3_odd_shape", dtype, got,
                msda.level_plain(v, loc, attn, h, w), d=d,
                windows_ok=bool((windows.long() == want_w).all()))
            check(bool((windows.long() == want_w).all()),
                  "dense_level_v3 odd shape: windows")
    check(max(fit_share) > 0.5 and min(fit_share) < 0.5,
          f"dense_level_v3: the cases do not exercise both branches: shares "
          f"of fitting tiles {fit_share}")
    return results


def kernel_phase_gather_rows(seed: int, captured):
    """The precomputed-rows gather: `ms_deform_attn_pallas` on the captured
    encoder call (K = 64) and at the decoder call's shape (K = 128, 650
    scattered queries), float32 and bfloat16 values, against
    `ms_deform_attn_plain`; the kernel alone, on the operands the wrapper
    builds, held against and timed beside the one library call that
    computes the same function on the same operands
    (`torch.nn.functional.embedding_bag` with per-sample weights, the
    tables of all (item, head) laid end to end; used nowhere in the port)
    and beside torch.gather + multiply + sum (the plain version, a
    composition). -> results by "encoder" / "decoder"."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_pallas import (
        gather_operands, gather_rows_cuda, gather_rows_plain,
        ms_deform_attn_pallas)

    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    bf16 = torch.bfloat16
    dec_levels = LEVELS * 2
    cases = [("encoder", LEVELS, *captured),
             ("decoder", dec_levels,
              *msda_inputs(dec_levels, DEC_QUERIES, False, gen, 1))]
    results = {}
    for name, shapes, value, loc, attn in cases:
        lq = loc.shape[1]
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            with torch.no_grad():
                got = ms_deform_attn_pallas(v, shapes, loc, attn)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_plain(v, shapes, loc, attn)
            check(got.dtype == dtype and got.shape == (1, lq, M * D),
                  f"ms_deform_attn_pallas {name}: output")
            err = held_against_plain(
                f"ms_deform_attn_pallas_{name}", dtype, got.float(),
                want.flatten(2), items=1, lq=lq, levels=len(shapes))
        v = value.to(bf16)
        reset_launch_counts()
        with torch.no_grad():
            ms_deform_attn_pallas(v, shapes, loc, attn)     # the path
        record_path()
        idx, weights, table = gather_operands(v, shapes, loc, attn)
        with torch.no_grad():
            same = gather_rows_cuda(idx, weights, table, M, shapes)
            comp = gather_rows_plain(idx, weights, table)
            check(bool(((same - comp).abs() <= 1e-5 + 1e-5 * comp.abs())
                       .all()), f"gather_rows {name}: kernel against "
                                "torch.gather composition")
            # the library call's operands: one table of B*S rows, one bag
            # of K rows per (item * head, query)
            b, s_rows = table.shape[:2]
            flat_table = table.reshape(b * s_rows, D)
            bags = (idx + s_rows * torch.arange(
                b, device="cuda", dtype=torch.int32)[:, None, None]
                ).reshape(b * lq, -1)
            bag_w = weights.reshape(b * lq, -1)

            def library():
                return torch.nn.functional.embedding_bag(
                    bags, flat_table, per_sample_weights=bag_w, mode="sum")

            lib_out = library().reshape(same.shape)
            lib_err = (same - lib_out).abs().max().item()
            check(bool(((same - lib_out).abs()
                        <= 1e-5 + 1e-5 * lib_out.abs()).all()),
                  f"gather_rows {name}: kernel against embedding_bag: "
                  f"{lib_err}")
            library_ms = time_ms(library, 20, INNER)
            op_ms = time_ms(lambda: ms_deform_attn_pallas(v, shapes, loc,
                                                          attn), 10, INNER)
            ms = time_ms(lambda: gather_rows_cuda(idx, weights, table, M,
                                                  shapes), 20, INNER)
            plain_ms = time_ms(lambda: gather_rows_plain(idx, weights, table),
                               5, INNER)
            comp_ms = time_ms(
                lambda: (torch.gather(
                    table, 1, idx.long().reshape(idx.shape[0], -1, 1)
                    .expand(-1, -1, D)).reshape(*idx.shape, D)
                    * weights[..., None]).sum(2), 5, INNER)
            fused_ms = time_ms(lambda: msda.ms_deform_attn(v, shapes, loc,
                                                           attn), 20, INNER)
        rows = touched_value_rows(loc, shapes)
        n_bytes = (idx.numel() * 8 + rows * D * 4 + same.numel() * 4)
        bound_ms, bound_by = bound(n_bytes, 2 * idx.numel() * D, FP32_FLOPS)
        phase("kernel", case=f"msda_gather_rows_{name}",
              table="float32, head-major", items=1, lq=lq, k=idx.shape[2],
              ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{library_ms:.4f}",
              library_max_abs_diff=f"{lib_err:.3e}",
              library_composition_ms=f"{comp_ms:.4f}",
              whole_op_with_operands_ms=f"{op_ms:.4f}",
              gather_kernel_same_call_ms=f"{fused_ms:.4f}",
              bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms,
            library_composition_ms=comp_ms, whole_op_with_operands_ms=op_ms,
            gather_kernel_ms=fused_ms)
        del idx, weights, table, same, comp, flat_table, bags, bag_w, lib_out
    # K = 24 corners (a ragged load of 32) and D = 5 channels
    value, loc, attn = odd_shape_inputs(gen, 5, ODD_LEVELS, 70)
    for dtype in (torch.float32, bf16):
        v = value.to(dtype)
        held_against_plain(
            "ms_deform_attn_pallas_odd_shape", dtype,
            ms_deform_attn_pallas(v, ODD_LEVELS, loc, attn).float(),
            msda.ms_deform_attn_plain(v, ODD_LEVELS, loc, attn).flatten(2),
            d=5, k=24)
    return results


def kernel_phase_patch_v6(seed: int, captured):
    """The flat chunk walk: `msda_patch_v6` on the captured encoder call
    (its path) and on N = 2 items with every 16th query's samples pushed
    across the border, float32 and bfloat16, against
    `ms_deform_attn_plain`; the wrapper's gradients; times of the op, of
    the kernel with the walk handed in, of `v6_walk`, of the plain version
    and of the gather kernel on the same call. -> result."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_patch import (
        V6_PH, V6_PW, V6_TQ, msda_patch, msda_patch_v6,
        msda_patch_v6_fwd_cuda, v6_max_chunks, v6_walk)

    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    bf16 = torch.bfloat16
    s_enc = sum(h * w for h, w in LEVELS)
    pushed = msda_inputs(LEVELS, s_enc, True, gen, TRAIN_BATCH)
    pushed[1][:, ::16] = pushed[1][:, ::16] * 1.2 - 0.1
    maxc = v6_max_chunks(LEVELS, V6_PH, V6_PW)
    errs = {}
    for what, (value, loc, attn) in (("captured call", captured),
                                     ("pushed across the border, N=2",
                                      pushed)):
        totals = v6_walk(LEVELS, loc)[1].float()
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            with torch.no_grad():
                got = msda_patch_v6(v, LEVELS, loc, attn)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_plain(v, LEVELS, loc, attn)
            errs[(what, dtype)] = held_against_plain(
                "msda_patch_v6", dtype, got, want, inputs=json.dumps(what),
                items=loc.shape[0], lq=s_enc, tile=V6_TQ,
                chunk=f"{V6_PH}x{V6_PW}",
                mean_chunks_walked=f"{totals.mean().item():.1f}",
                max_chunks_walked=int(totals.max().item()),
                all_chunks=maxc)
    s_odd = sum(h * w for h, w in ODD_LEVELS)
    for d in (5, 6):                # the other staging words, a ring of 3
        value, loc, attn = odd_shape_inputs(gen, d, ODD_LEVELS, s_odd)
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            held_against_plain(
                "msda_patch_v6_odd_shape", dtype,
                msda_patch_v6_fwd_cuda(v, ODD_LEVELS, loc, attn, tq=ODD_TQ,
                                       ph=4, pw=8, nslots=3),
                msda.ms_deform_attn_plain(v, ODD_LEVELS, loc, attn), d=d)
    value, loc, attn = captured
    v = value.to(bf16)
    reset_launch_counts()
    with torch.no_grad():
        msda_patch_v6(v, LEVELS, loc, attn)                 # the path
    record_path()
    g = torch.randn(1, s_enc, M, D, device="cuda", generator=gen)
    for dtype in (torch.float32, bf16):
        reset_launch_counts()
        grads_against_plain(
            "msda_patch_v6_grad", dtype,
            lambda v_, lo_, at: msda_patch_v6(v_, LEVELS, lo_, at),
            lambda v_, lo_, at: msda.ms_deform_attn_plain(v_, LEVELS, lo_,
                                                          at),
            (value.to(dtype), loc, attn), g, items=1)
        counts = {k: n for k, n in msda.launch_counts().items() if n}
        check(counts == {"msda_patch_v6": 1, "msda_bwd": 1},
              f"msda_patch_v6 and its backward launched {counts}")
    walk = v6_walk(LEVELS, loc)
    with torch.no_grad():
        ms = time_ms(lambda: msda_patch_v6(v, LEVELS, loc, attn), 20, INNER)
        kernel_ms = time_ms(lambda: msda_patch_v6_fwd_cuda(
            v, LEVELS, loc, attn, walk=walk), 20, INNER)
        walk_ms = time_ms(lambda: v6_walk(LEVELS, loc), 10, INNER)
        plain_ms = time_ms(lambda: msda.ms_deform_attn_plain(
            v, LEVELS, loc, attn), 5, INNER)
        gather_ms = time_ms(lambda: msda_patch(v, LEVELS, loc, attn), 20,
                            INNER)
    rows = touched_value_rows(loc, LEVELS)
    n_bytes = (rows * D * 2 + loc.numel() * 4 + attn.numel() * 4
               + s_enc * M * D * 4 + s_enc * 4)
    bound_ms, bound_by = bound(
        n_bytes, s_enc * M * len(LEVELS) * P * D * 10, FP32_FLOPS)
    phase("kernel", case="msda_patch_v6", dtype="bfloat16", items=1,
          lq=s_enc, ms=f"{ms:.4f}", kernel_alone_ms=f"{kernel_ms:.4f}",
          v6_walk_ms=f"{walk_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          gather_kernel_ms=f"{gather_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
          bound_by=bound_by)
    return dict(max_abs_err=errs[("captured call", bf16)], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, kernel_alone_ms=kernel_ms,
                v6_walk_ms=walk_ms, gather_kernel_ms=gather_ms)


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
    record_path()

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
    record_path()
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


# --------------------------------------------------------------------------
# training: two-frame track-query steps of the exact-MSDA flagship
# --------------------------------------------------------------------------

TRAIN_OBJECTS = 20             # boxes per image, in `max_objects` = 100 slots
# route v2 (and v4) against route v5 from the same state: the encoder
# kernels round differently (float32 partial sums per level against one sum over
# all levels, each rounded to bfloat16), 12 bfloat16 layers amplify that,
# and a changed Hungarian match moves the loss in a step. Held: the first
# step's loss (the forwards), its grad_norm (the backward through either
# route's launches) and the second step's loss (the update that the first
# step's gradients made)
ROUTE_LOSS_RTOL = 0.02
# float32 train step on the card (kernels) against the same step on the CPU
# (plain versions): loss and grad_norm to 1e-4; gradients name by name to
# 1e-4 + 1e-3 |ref| elementwise. The model's gradient jumps where a ReLU
# input changes sign and where a sampling location crosses a cell border,
# so an activation that falls on the other side moves the gradients
# upstream of it (one channel of a convolution, one row of a linear layer)
# and nothing else: a small share of all elements may miss the elementwise
# bound while every tensor as a whole stays within a fraction of |ref|_2
# and no element errs by more than a fraction of its tensor's largest (a
# wrong kernel misses all three by orders of magnitude). Two references,
# each with (share of elements out, per-tensor L2, per-tensor max) limits:
# the CPU's float32 step, where both sides' float32 rounding is in the
# error, and the CPU's float64 step (float64 weights and activations; the
# plain MSDA, the attention logits and the heads stay float32 inside it),
# where only the card's is: four to ten times tighter. The CPU's float32
# step, read against its float64 step, misses the elementwise bound as
# often as the card's does or more: the misses are float32's, on either
# device, not the kernels'.
REF_LOSS_RTOL = 1e-4
REF_GRAD_TOL = (1e-4, 1e-3)
REF_LIMITS = {"cpu": (1e-3, 2e-3, 1e-2),
              "cpu_float64": (1e-4, 5e-4, 2.5e-3)}


def synthetic_train_pack(cfg, seed: int, step: int):
    """`TRAIN_BATCH` frame pairs of the drifting texture with
    `TRAIN_OBJECTS` (less two on the second image) drifting boxes each and
    their track ids, padded to `cfg.max_objects` slots."""
    from trackformer_tpu_torch.structures import FrameBatch, empty_targets

    b, t = TRAIN_BATCH, cfg.max_objects
    pairs = [synthetic_frames(2, seed + 1000 * step + 10 * i)
             for i in range(b)]
    valid_hw = torch.tensor([VALID_HW] * b)
    rng = np.random.RandomState(seed + step)
    scale = np.array([VALID_HW[1] / BUCKET[1], VALID_HW[0] / BUCKET[0]])
    packs = []
    centre = rng.uniform(0.1, 0.9, (b, TRAIN_OBJECTS, 2)) * scale
    size = rng.uniform(0.03, 0.15, (b, TRAIN_OBJECTS, 2))
    for frame in range(2):
        targets = empty_targets(b, t, "cuda")
        boxes = np.concatenate([centre + 0.01 * frame
                                * rng.randn(b, TRAIN_OBJECTS, 2), size], -1)
        n_obj = [TRAIN_OBJECTS - 2 * i for i in range(b)]
        targets.boxes[:, :TRAIN_OBJECTS] = torch.from_numpy(
            boxes.astype(np.float32)).cuda()
        for i, n in enumerate(n_obj):
            targets.valid[i, :n] = True
            targets.track_ids[i, :n] = torch.arange(n, dtype=torch.int32)
        targets.size[:] = valid_hw
        targets.orig_size[:] = torch.tensor([[1080, 1920]] * b)
        batch = FrameBatch.from_images(
            torch.cat([p[frame] for p in pairs]), valid_hw)
        packs.append((batch, targets))
    return {"prev_batch": packs[0][0], "prev_targets": packs[0][1],
            "batch": packs[1][0], "targets": packs[1][1]}


def train_run(seed: int):
    """The full-width exact-MSDA flagship in bfloat16, B = 2 frame pairs at
    800x1344: 3 optimizer steps on route v5, then 2 on route v2 and 2 on
    route v4, each from the same start state and the same draws. Every
    step's launches go into `PATH_SHAPES`."""
    from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                              make_train_step)
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    cfg = FlagshipConfig().replace(dataset="mot_crowdhuman")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model, crit_cfg, _, track_cfg = build_model(cfg, "cuda", generator=gen,
                                                train=True)
    optimizer = make_optimizer(cfg, model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    frozen = [k for k, g in optimizer.labels.items() if g == "frozen"]
    k_slots = cfg.max_objects + int(np.ceil(
        cfg.track_query_false_positive_prob * cfg.max_objects)) + 1
    phase("train", model="flagship exact MSDA", dtype=cfg.compute_dtype,
          batch=TRAIN_BATCH, image=f"{BUCKET[0]}x{BUCKET[1]}",
          queries=cfg.num_queries, track_query_slots=k_slots,
          objects_per_image=TRAIN_OBJECTS, dropout=cfg.dropout,
          tensors=len(optimizer.labels), frozen_tensors=len(frozen),
          params=sum(p.numel() for p in model.parameters()))
    check(cfg.num_queries + k_slots == TRAIN_DEC_QUERIES,
          f"decoder queries {cfg.num_queries + k_slots}")

    split = {}

    def timings(tag):
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[tag] = (now - timings.last) * 1e3
        timings.last = now

    step_fn = make_train_step(model, crit_cfg, optimizer, track_cfg,
                              tracking=True, timings=timings)
    enc = 12   # encoder layer calls per forward: 6 layers x 2 frames
    want = {
        "v5": {"msda_patch": 2 * enc, "ms_deform_attn": 12,
               "msda_bwd": enc + 6},
        "v2": {"ms_deform_attn": 12,
               "dense_level_pallas_v2": 2 * enc * len(LEVELS),
               "msda_bwd": enc * len(LEVELS) + 6},
        "v4": {"ms_deform_attn": 12,
               "dense_level_pallas_v4": 2 * enc * len(LEVELS),
               "msda_bwd": enc * len(LEVELS) + 6},
    }
    by_route = {}
    saved_impl = msda.PALLAS_SKIP_IMPL
    try:
        for route, n_steps in (("v5", 3), ("v2", 2), ("v4", 2)):
            msda.PALLAS_SKIP_IMPL = route
            model.load_state_dict(start)
            state = TrainState.create(model, optimizer)
            before = {k: v.clone() for k, v in state.params.items()}
            gen.manual_seed(seed + 1)
            torch.cuda.reset_peak_memory_stats()
            step_ms, splits = [], []
            for step in range(n_steps):
                pack = synthetic_train_pack(cfg, seed, step)
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = timings.last = time.perf_counter()
                state, metrics = step_fn(state, pack, gen)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                splits.append(dict(split))
                counts = launch_counts()
                record_path()
                values = {k: float(v) for k, v in metrics.items()}
                bad = [k for k, v in values.items() if not np.isfinite(v)]
                phase("train", route=route, step=step,
                      loss=f"{values['loss']:.4f}",
                      grad_norm=f"{values['grad_norm']:.4f}",
                      loss_keys=len(values) - 2, step_ms=f"{step_ms[-1]:.1f}",
                      launches=json.dumps(
                          {k: v for k, v in counts.items() if v},
                          separators=(",", ":")))
                check(not bad, f"train {route} step {step}: non-finite {bad}")
                check(values["grad_norm"] > 0, f"train {route}: zero "
                                               "gradient")
                for name, n in counts.items():
                    check(n == want[route].get(name, 0),
                          f"train {route} step {step}: {n} {name} launches, "
                          f"want {want[route].get(name, 0)}")
                by_route.setdefault(route, []).append(
                    (values["loss"], values["grad_norm"]))
                if step == 0:
                    want_keys = set(crit_cfg.weight_dict) | {
                        "class_error", "loss", "grad_norm"} | {
                        f"cardinality_error{sfx}" for sfx in
                        [""] + [f"_{i}" for i in range(cfg.dec_layers - 1)]}
                    check(set(values) == want_keys,
                          f"train: loss keys {sorted(set(values) ^ want_keys)}")
            steady = step_ms[1:]
            steady_split = {k: statistics.median(s[k] for s in splits[1:])
                            for k in splits[0]}
            moved = [k for k, g in optimizer.labels.items()
                     if g != "frozen"
                     and not torch.equal(before[k], state.params[k])]
            still = [k for k in frozen
                     if torch.equal(start[k], model.state_dict()[k])]
            n_train = len(optimizer.labels) - len(frozen)
            phase("train", route=route, steps=n_steps,
                  steady_median_step_ms=f"{statistics.median(steady):.1f}",
                  split_ms=json.dumps({k: round(v, 1)
                                       for k, v in steady_split.items()},
                                      separators=(",", ":")),
                  peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
                  trainable_moved=f"{len(moved)}/{n_train}",
                  frozen_unchanged=f"{len(still)}/{len(frozen)}")
            check(len(moved) == n_train, f"train {route}: "
                  f"{n_train - len(moved)} trainable tensors did not move")
            check(len(still) == len(frozen), f"train {route}: a frozen "
                                             "tensor changed")
    finally:
        msda.PALLAS_SKIP_IMPL = saved_impl
    for route in ("v2", "v4"):
        pairs = {"first_step_loss": (by_route["v5"][0][0],
                                     by_route[route][0][0]),
                 "first_step_grad_norm": (by_route["v5"][0][1],
                                          by_route[route][0][1]),
                 "second_step_loss": (by_route["v5"][1][0],
                                      by_route[route][1][0])}
        ok = all(abs(b - a) <= ROUTE_LOSS_RTOL * abs(a)
                 for a, b in pairs.values())
        phase("train", **{f"{k}_{r}": f"{v:.4f}" for k, ab in pairs.items()
                          for r, v in zip(("v5", route), ab)},
              tol=f"{ROUTE_LOSS_RTOL}*|v5|", ok=ok)
        check(ok, f"train: route {route} against route v5: {pairs}")


def grad_readings(got: dict, ref: dict, limits) -> dict:
    """Gradients name by name against a reference: the elements past the
    elementwise bound and their share over its limit, the worst per-tensor
    L2 and largest error over theirs, and the tensors that hold the most
    outliers."""
    atol, rtol = REF_GRAD_TOL
    share_lim, l2_lim, max_lim = limits
    worst_l2, worst_max, n_out, n_all, holders = (0.0, ""), (0.0, ""), 0, 0, []
    for name, want in ref.items():
        err = (got[name] - want).abs()
        out = int((err > atol + rtol * want.abs()).sum())
        if out:
            holders.append((out, name))
        n_out += out
        n_all += want.numel()
        l2 = err.norm().item() / (
            l2_lim * want.norm().item() + atol * want.numel() ** 0.5)
        top = err.max().item() / (atol + max_lim * want.abs().max().item())
        worst_l2 = max(worst_l2, (l2, name))
        worst_max = max(worst_max, (top, name))
    ok = (n_out / n_all <= share_lim and worst_l2[0] <= 1.0
          and worst_max[0] <= 1.0)
    return dict(elements=n_all, elements_out=n_out,
                share_out=f"{n_out / n_all:.2e}",
                tensors_with_outliers=len(holders),
                most_outliers=json.dumps(
                    [f"{name}:{out}" for out, name in sorted(holders)[-3:]]),
                worst_l2_err_over_tol=f"{worst_l2[0]:.3f}",
                worst_l2_gradient=worst_l2[1],
                worst_max_err_over_tol=f"{worst_max[0]:.3f}",
                worst_max_gradient=worst_max[1],
                tol=f"elementwise:{atol:g}+{rtol:g}*|ref| for all but "
                    f"{share_lim:g} of all elements; per tensor "
                    f"l2:{l2_lim:g}*|ref|_2+{atol:g}*sqrt(n) "
                    f"max:{atol:g}+{max_lim:g}*max|ref|", ok=ok)


def train_reference_run(seed: int):
    """One float32 train step at 128x192, 2 + 2 layers, full width, on the
    card (kernels) against the same step on the CPU (plain versions) in
    float32 and in float64, with dropout 0 and the track-query draws
    pinned: loss, grad_norm and every gradient, name by name, within
    `REF_LIMITS`. The CPU's float32 step is also read against its float64
    step (no check): that reading shows whose the misses of the
    elementwise bound are."""
    import copy

    from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                              make_train_step)
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.models.deformable_transformer import \
        MSDeformAttnModule
    from trackformer_tpu_torch.structures import FrameBatch, empty_targets
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    t, n_obj = 10, 7
    cfg = FlagshipConfig().replace(
        dataset="mot_crowdhuman", compute_dtype="float32", enc_layers=2,
        dec_layers=2, num_queries=100, max_objects=t, dropout=0.0)
    gen = torch.Generator().manual_seed(seed)
    cpu_model, crit_cfg, _, track_cfg = build_model(cfg, "cpu", gen,
                                                    train=True)
    # The initial sampling offsets are whole cells, so encoder samples sit
    # exactly on cell borders, where the location gradient jumps and the
    # last bit of a reference point decides the side. Shift every offset by
    # a fraction of a cell, as training does.
    with torch.no_grad():
        for mod in cpu_model.modules():
            if isinstance(mod, MSDeformAttnModule):
                bias = mod.sampling_offsets.bias
                bias.add_(0.15 + 0.2 * torch.rand(bias.shape, generator=gen))
    rng = np.random.RandomState(seed)
    imgs = [torch.from_numpy(rng.randn(TRAIN_BATCH, 128, 192, 3)
                             .astype(np.float32)) for _ in range(2)]
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (TRAIN_BATCH, t, 2)),
                            rng.uniform(0.05, 0.3, (TRAIN_BATCH, t, 2))],
                           -1).astype(np.float32)
    forced = {"num": 4, "num_fps": 1,
              "order": np.tile(np.arange(t), (TRAIN_BATCH, 1)),
              "fp_seed_pos": np.tile(np.arange(t), (TRAIN_BATCH, 1))}
    results = {}
    for tag, dev, dtype in (("card", "cuda", torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu_float64", "cpu", torch.float64)):
        model = copy.deepcopy(cpu_model).to(dev, dtype)
        optimizer = make_optimizer(cfg, model)
        state = TrainState.create(model, optimizer)
        step_fn = make_train_step(model, crit_cfg, optimizer, track_cfg,
                                  tracking=True, return_grads=True)
        targets = empty_targets(TRAIN_BATCH, t, dev)
        targets.boxes[:] = torch.from_numpy(boxes).to(dev)
        targets.valid[:, :n_obj] = True
        targets.track_ids[:, :n_obj] = torch.arange(n_obj, dtype=torch.int32)
        valid = torch.tensor([[120, 180]] * TRAIN_BATCH)
        pack = {"prev_batch": FrameBatch.from_images(imgs[0].to(dev), valid),
                "prev_targets": targets,
                "batch": FrameBatch.from_images(imgs[1].to(dev), valid),
                "targets": targets}
        reset_launch_counts()
        _, metrics = step_fn(state, pack, None, forced=forced)
        results[tag] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                        {k: v.cpu() for k, v in metrics["_grads"].items()},
                        launch_counts())
        del model, state, step_fn, metrics
    loss_c, norm_c, grads_c, counts = results["card"]
    for name, got in grads_c.items():
        check(bool(torch.isfinite(got).all()),
              f"train_reference: non-finite gradient {name}")
    phase("train_reference", seed=seed, step="float32, 128x192, 2+2 layers, "
          "B=2", gradients=len(grads_c),
          **{f"{k}_{tag}": f"{results[tag][i]:.6f}"
             for i, k in enumerate(("loss", "grad_norm")) for tag in results},
          card_launches=json.dumps({k: v for k, v in counts.items() if v},
                                   separators=(",", ":")))
    check(counts["msda_bwd"] > 0 and counts["msda_patch"] > 0,
          f"train_reference: the card's step launched {counts}")
    failed = []
    for ref in ("cpu", "cpu_float64"):
        loss_r, norm_r, grads_r, _ = results[ref]
        scalars_ok = (
            abs(loss_c - loss_r) <= REF_LOSS_RTOL * max(1.0, abs(loss_r))
            and abs(norm_c - norm_r) <= REF_LOSS_RTOL * max(1.0, abs(norm_r)))
        r = grad_readings(grads_c, grads_r, REF_LIMITS[ref])
        r["ok"] = r["ok"] and scalars_ok
        phase("train_reference", seed=seed, held=f"card against {ref}",
              loss_grad_norm_tol=f"{REF_LOSS_RTOL:g}*max(1,|ref|)", **r)
        if not r["ok"]:
            failed.append(ref)
    r = grad_readings(results["cpu"][2], results["cpu_float64"][2],
                      REF_LIMITS["cpu"])
    phase("train_reference", seed=seed,
          reading="cpu against cpu_float64 (no check)", **r)
    check(not failed, f"train_reference seed {seed}: the card's step "
                      f"differs from {failed}")


PHASES = ("msda", "window", "msda_bwd", "dense_v2", "dense_v4", "dense_v3",
          "gather_rows", "patch_v6", "exact", "fast", "train",
          "train_reference")
# frames of the exact tracker's runs on the other routes
ROUTE_FRAMES = 3


def main() -> int:
    global OLD_BWD_LIB
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=6,
                    help="frames of each tracker run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--old-msda-bwd", default=None, metavar="PATH",
                    help="an earlier csrc/msda_bwd.cu (a copy outside the "
                         "package) to time beside the backward kernel")
    args = ap.parse_args()
    phases = [x for x in args.phases.split(",") if x]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "trackformer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from trackformer_tpu_torch.ops import msda
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
    libs = all_libs()
    if args.old_msda_bwd:
        OLD_BWD_LIB = old_bwd_lib(args.old_msda_bwd)
        libs.append(OLD_BWD_LIB)
    build_all(libs)
    for lib in libs:
        info = lib.info()
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        phase("build", source=info["source"],
              flags=json.dumps(" ".join(NVCC_FLAGS[:2])),
              seconds=f"{info['seconds']:.2f}", ptxas=json.dumps(regs))
    phase("build", all_seconds=f"{time.perf_counter() - t0:.2f}")

    # the deployed tracking checkpoint (cfgs/track.yaml) is trained on
    # mot_crowdhuman: a 20-class head
    exact_cfg = FlagshipConfig().replace(dataset="mot_crowdhuman")
    fast_cfg = FlagshipConfig.tpu_fast(dataset="mot_crowdhuman")
    kmsda = kwin = kbwd = kv2 = kv4 = kv3 = krows = kv6 = None
    fast_counts = batched_counts = None
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if "msda" in phases:
            kmsda = kernel_phase_msda(args.seed)
        if "window" in phases:
            kwin = kernel_phase_window(args.seed)
        if "msda_bwd" in phases:
            kbwd = kernel_phase_msda_bwd(args.seed)
        if "dense_v2" in phases:
            kv2 = kernel_phase_dense_v2(args.seed)
        if "dense_v4" in phases:
            kv4 = kernel_phase_dense_v4(args.seed)
        if {"dense_v3", "gather_rows", "patch_v6"} & set(phases):
            captured = captured_encoder_call(args.seed)
            if "dense_v3" in phases:
                kv3 = kernel_phase_dense_v3(args.seed, captured)
            if "gather_rows" in phases:
                krows = kernel_phase_gather_rows(args.seed, captured)
            if "patch_v6" in phases:
                kv6 = kernel_phase_patch_v6(args.seed, captured)
            del captured

        if "exact" in phases:
            model, post = smoke_model(exact_cfg, args.seed, "exact")
            tracker_run("exact", exact_cfg, model, post,
                        args.frames, args.seed,
                        {"msda_patch": 12, "ms_deform_attn": 6})
            saved = (msda.PALLAS_SKIP_IMPL, msda.MSDA_DEC_SKIP)
            try:
                # 2 frames x 6 layers x 4 levels through kernel v4
                msda.PALLAS_SKIP_IMPL = "v4"
                tracker_run("exact_v4", exact_cfg, model, post, ROUTE_FRAMES,
                            args.seed, {"dense_level_pallas_v4": 48,
                                        "ms_deform_attn": 6})
                # per decoder layer: the two frames' 100x168 levels through
                # kernel v4, the other six levels in one gather launch
                msda.PALLAS_SKIP_IMPL, msda.MSDA_DEC_SKIP = saved[0], True
                tracker_run("exact_decskip", exact_cfg, model, post,
                            ROUTE_FRAMES, args.seed,
                            {"msda_patch": 12, "dense_level_pallas_v4": 12,
                             "ms_deform_attn": 6})
            finally:
                msda.PALLAS_SKIP_IMPL, msda.MSDA_DEC_SKIP = saved
            reference_run("exact", model, 1)
            del model

        if "fast" in phases:
            model, post = smoke_model(fast_cfg, args.seed, "fast")
            fast_counts = tracker_run("fast", fast_cfg, model, post,
                                      args.frames, args.seed,
                                      {"fused_window_layer": 6,
                                       "ms_deform_attn": 6})
            batched_counts = batched_run(fast_cfg, model, post, 8, 4,
                                         args.seed)
            reference_run("fast", model, 2)
            del model

        if "train" in phases:
            train_run(args.seed)
        if "train_reference" in phases:
            # a second seed: the limits were not fitted to one draw
            train_reference_run(args.seed)
            train_reference_run(args.seed + 1)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    if phases != list(PHASES):
        print(json.dumps({"ok": True, "partial": phases, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    csrc = "trackformer_tpu_torch/csrc/"
    msda_src, win_src = csrc + "msda_fwd.cu", csrc + "window_layer_fwd.cu"
    bwd_src, v2_src = csrc + "msda_bwd.cu", csrc + "msda_dense_v2_fwd.cu"
    v4_src, v3_src = (csrc + "msda_dense_v4_fwd.cu",
                      csrc + "msda_dense_v3_fwd.cu")
    rows_src, v6_src = (csrc + "msda_gather_rows_fwd.cu",
                        csrc + "msda_patch_v6_fwd.cu")
    pallas_py = "trackformer_tpu/ops/msda_pallas.py"
    no_route = "public op, no route in the JAX package"
    bf16 = torch.bfloat16
    s_enc = sum(h * w for h, w in LEVELS)
    dec_levels = LEVELS * 2
    patch_py = "trackformer_tpu/ops/msda_patch.py"
    dense_py = "trackformer_tpu/ops/msda_dense.py"
    # (name, source, TPU kernel, the kernel phase's result at this shape,
    # the shape as the wrappers count it: count name, items, queries,
    # levels). Launches are the main paths' at exactly that shape.
    msda_entries = [
        ("msda_fwd via msda_patch (exact encoder, all levels, B = 1)",
         msda_src, patch_py + ":108", kmsda[("encoder", bf16)],
         ("msda_patch", 1, s_enc, LEVELS)),
        ("msda_fwd via msda_patch (training, encoder, all levels, B = 2)",
         msda_src, patch_py + ":108", kmsda[("encoder_train", bf16)],
         ("msda_patch", TRAIN_BATCH, s_enc, LEVELS)),
        ("msda_fwd via ms_deform_attn (decoder, 8 levels, B = 1)",
         msda_src, dense_py + ":216", kmsda[("decoder", bf16)],
         ("ms_deform_attn", 1, DEC_QUERIES, dec_levels)),
        ("msda_fwd via ms_deform_attn (decoder, 8 levels, B = 8)",
         msda_src, dense_py + ":216", kmsda[("decoder_b8", bf16)],
         ("ms_deform_attn", 8, DEC_QUERIES, dec_levels)),
        ("msda_fwd via ms_deform_attn (training, decoder, 8 levels, 611 "
         "queries, B = 2)",
         msda_src, dense_py + ":216", kmsda[("decoder_train", bf16)],
         ("ms_deform_attn", TRAIN_BATCH, TRAIN_DEC_QUERIES, dec_levels)),
        ("msda_fwd via ms_deform_attn (training, previous frame's decoder, "
         "8 levels, 500 queries, B = 2)",
         msda_src, dense_py + ":216", kmsda[("decoder_train_prev", bf16)],
         ("ms_deform_attn", TRAIN_BATCH, TRAIN_PREV_QUERIES, dec_levels)),
        ("msda_fwd via ms_deform_attn (MSDA_DEC_SKIP: the decoder's other "
         "six levels, B = 1)",
         msda_src, dense_py + ":216", kmsda[("decoder_rest", bf16)],
         ("ms_deform_attn", 1, DEC_QUERIES, (LEVELS[1:] * 2))),
        ("msda_bwd (training, encoder call, all levels, B = 2)",
         bwd_src, patch_py + ":367", kbwd[("encoder", bf16)],
         ("msda_bwd", TRAIN_BATCH, s_enc, LEVELS)),
        ("msda_bwd (training, decoder call, 8 levels, B = 2)",
         bwd_src, dense_py + ":780", kbwd[("decoder", bf16)],
         ("msda_bwd", TRAIN_BATCH, TRAIN_DEC_QUERIES, dec_levels)),
    ]
    for lvl, hw in enumerate(LEVELS):
        at = f"route v2, encoder level {lvl} {hw[0]}x{hw[1]}, B = 2)"
        msda_entries += [
            ("msda_bwd (training, " + at, bwd_src, dense_py + ":780",
             kbwd[(f"encoder_l{lvl}", bf16)],
             ("msda_bwd", TRAIN_BATCH, s_enc, (hw,))),
            ("msda_dense_v4_fwd via dense_level_pallas_v4p (route v4, "
             f"encoder level {lvl} {hw[0]}x{hw[1]}, B = 1)",
             v4_src, dense_py + ":356", kv4[("enc", 1, lvl)],
             ("dense_level_pallas_v4", 1, s_enc, (hw,))),
            ("msda_dense_v4_fwd via dense_level_pallas_v4p (training, "
             + at.replace("route v2", "route v4"),
             v4_src, dense_py + ":356", kv4[("enc", TRAIN_BATCH, lvl)],
             ("dense_level_pallas_v4", TRAIN_BATCH, s_enc, (hw,))),
            (f"msda_dense_v3_fwd via dense_level_pallas_v3 (encoder level "
             f"{lvl} {hw[0]}x{hw[1]} of a captured call, B = 1)",
             v3_src, dense_py + ":270", {**kv3[lvl], "path": no_route},
             ("dense_level_pallas_v3", 1, s_enc, (hw,))),
            ("msda_dense_v2_fwd via dense_level_pallas_v2 (training, " + at,
             v2_src, dense_py + ":68", kv2[lvl],
             ("dense_level_pallas_v2", TRAIN_BATCH, s_enc, (hw,)))]
    msda_entries += [
        ("msda_dense_v4_fwd via dense_level_pallas_v4p (MSDA_DEC_SKIP, "
         "decoder level 100x168, 650 queries, B = 1)",
         v4_src, dense_py + ":356", kv4[("dec", 1, DEC_QUERIES)],
         ("dense_level_pallas_v4", 1, DEC_QUERIES, (LEVELS[0],))),
        ("msda_gather_rows_fwd via ms_deform_attn_pallas (a captured "
         "encoder call, all levels, B = 1)",
         rows_src, pallas_py + ":34", {**krows["encoder"], "path": no_route},
         ("ms_deform_attn_pallas", 1, s_enc, LEVELS)),
        ("msda_gather_rows_fwd via ms_deform_attn_pallas (the decoder "
         "call's shape, 8 levels, 650 queries, B = 1)",
         rows_src, pallas_py + ":34", {**krows["decoder"], "path": no_route},
         ("ms_deform_attn_pallas", 1, DEC_QUERIES, dec_levels)),
        ("msda_patch_v6_fwd via msda_patch_v6 (a captured encoder call, all "
         "levels, B = 1)",
         v6_src, patch_py + ":411", {**kv6, "path": no_route},
         ("msda_patch_v6", 1, s_enc, LEVELS)),
    ]
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": PATH_SHAPES.get(key, 0),
                **result}
               for name, source, replaces, result, key in msda_entries]
    # every shape the main paths launched was held in a kernel phase
    unheld = sorted(set(PATH_SHAPES) - {e[4] for e in msda_entries})
    if unheld:
        print(f"chip_smoke: FAILED: the main paths launched at shapes no "
              f"kernel phase held: {unheld}", file=sys.stderr, flush=True)
        return 1
    kernels += [
        {"name": f"window_layer_fwd via fused_window_layer (fast encoder, "
                 f"B = {batch})",
         "route": "cuda", "source": win_src,
         "replaces": "trackformer_tpu/ops/window_attn.py:56",
         "launches": counts["fused_window_layer"], **kwin[batch]}
        for batch, counts in ((1, fast_counts), (8, batched_counts))]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        print(f"chip_smoke: FAILED: no main path launched {idle}",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
