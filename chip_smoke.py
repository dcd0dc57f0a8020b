#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (trackformer_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--frames 6] [--seed 0] [--phases a,b,...]

Phases, a few lines each (`--phases` runs a subset and then ends with a
last line marked "partial"; the kernels line needs all of them):
  device: requires CUDA, prints `nvidia-smi` name and power limit;
  build: compiles the five kernel sources of trackformer_tpu_torch/csrc
     for sm_90a, one nvcc each, started together; reports each one's seconds
     and registers;
  msda: holds each MSDA wrapper's CUDA launch against the plain PyTorch
     version at the main paths' shapes (encoder all levels at B = 1 and at
     the training step's B = 2; decoder eight levels at B = 1, at the
     lockstep step's B = 8 and at the training step's 611 and 500 queries,
     B = 2; the six levels that `MSDA_DEC_SKIP` leaves to the gather kernel;
     one decoder level; `cli.track`'s 768x1344 frames: the encoder at
     B = 1, the decoder at B = 1 and 8; the training step's encoder and
     decoder calls in `cli.train`'s 608x1088 and 1088x1920 buckets), in
     float32 with TF32 off and in
     bfloat16, and
     times both; then three small calls for the kernel's other paths (D =
     6, a value one element off its alignment, 16-byte words with samples
     outside [0, 1] on every level); each case line shows the host's plan
     (`msda.fwd_plan`: word and warps per block); with `--old-msda-fwd
     PATH` (an earlier `csrc/msda_fwd.cu`, copied outside the package)
     times that design and this one through their C entry points, in turns
     (`old_ms`, `entry_ms`), beside `ms`, the wrapper's time;
  window: holds the window layer's kernels (bfloat16: five stage kernels
     over all tokens; float32: a block per (window, 64 query rows))
     against its plain
     version at the fast mode's B = 1 and B = 8 shapes (380 and 3,040
     windows of 64 tokens, C = 288; at B = 2, 760, `cli.train`'s
     validation; and at `cli.track`'s 768x1344 frames, 342 and 2,736),
     both shift parities, with the key
     padding of the 750x1333 region in the 800x1344 bucket (fully-padded
     windows present), in float32 and bfloat16; at B = 8 each stage kernel
     against its plain stage, with its time, bound and the blocks per SM
     the card grants it; times the layer, the plain version, a library
     composition (cuBLAS linears + scaled_dot_product_attention +
     layer_norm) and the weight packing; with `--old-window-layer PATH`
     (an earlier `csrc/window_layer_fwd.cu`, copied outside the package)
     times that design beside this one, in turns (`old_ms`);
  msda_bwd: holds the backward kernel's three gradients against autograd
     through the plain version at the training step's encoder call (N = 2,
     Lq = S = 22,323, 4 levels), its decoder call (N = 2, Lq = 611, 8
     levels), both in `cli.train`'s 608x1088 and 1088x1920 buckets, and
     route v2's four
     single-level encoder calls, float32 and
     bfloat16, with samples outside [0, 1]; then at two small calls that
     hold the scalar path (D = 6) and a plan with one level in shared
     memory and one not; prints each call's plan (`msda.bwd_plan`) and the
     reductions each design issues there; with `--old-msda-bwd PATH` (an
     earlier `csrc/msda_bwd.cu`, copied outside the package) times that
     design beside this one, in turns (`old_ms`);
  dense_v2: holds the block-skipping level kernel against the plain level
     on each of the four encoder levels, float32 and bfloat16, N = 1 and 2,
     with the initial offsets and with offsets six times as large, and its
     row bands against `v2_row_band` at the tile of its plan
     (`walk_plan`, printed in each case line); times it, the plain version,
     the gather kernel and the `grid_sample` composition on the same level,
     and with `--old-dense-v2 PATH` (an earlier `csrc/msda_dense_v2_fwd.cu`,
     copied outside the package) that design and this one through their C
     entry points in turns (`old_ms`, `entry_ms`, `ms_turns`; with
     `--old-walk PATH`, an earlier one-level walk's copy, that walk too:
     `old_walk_ms`); then tiles
     whose band holds rows with no sample, supports on window borders and
     the odd staging words; then the differentiable wrapper
     `dense_level_pallas_v2` on a slice of the value table, and the whole
     encoder call through route "v2" of `ms_deform_attn`: output and the
     three gradients against autograd through the plain version;
  dense_v4: holds the range-walking level kernel (TPU kernel v4 / v4p)
     against the plain level on each encoder level, N = 1 and 2, float32
     and bfloat16, with the initial offsets and with offsets six times as
     large, sorted in 64-column chunks (the call's one permutation, as route
     "v4" does) and unsorted at full width; on the decoder's 100x168 level
     with 650 (N = 1), 611 and 500 (N = 2) scattered queries; tiles whose
     range holds windows with no sample and supports that straddle chunk
     and window borders; its walk bounds against `v4_ranges` at the tile
     of its plan (`walk_plan`, printed in each case line); times beside the
     gather kernel's, the block-skipping kernel's and the `grid_sample`
     composition's on the same level, and with `--old-dense-v4 PATH` the
     earlier design's (and with `--old-walk PATH` an earlier walk's)
     through the C entry points in turns; the
     differentiable wrappers' gradients; head rows wider than a warp (the
     walk's two passes): float32 rows of 160 channels, and D = 36
     bfloat16 rows at a value pointer one element off its alignment;
     then the whole encoder call through route "v4" and the whole decoder
     call under `MSDA_DEC_SKIP`, output and gradients against the plain
     version, with their launch counts;
  dense_v3, gather_rows, patch_v6: the three kernels that no route of the
     JAX package reaches. Their path is the public op on the inputs of one
     real encoder MSDA call of the full-width exact model on a frame (the
     value after its projection, the layer's own locations and weights):
     `dense_level_pallas_v3` per level (the walk in a spatial sort and
     64-column chunks; windows against `v3_windows` at the tile of its
     plan, both the fitting and the full-width branch, also N = 2 with
     offsets six times as large and with samples pushed across the
     border), `ms_deform_attn_pallas` (two kernels: the corner build, bit
     for bit against its plain version with float32 and bfloat16
     locations and weights, and the gather reading the value in place,
     also with every corner of a query on one row and every corner on one
     row; also at the decoder call's shape; its device time from a CUDA
     graph, the corner build's, the whole op's, and `embedding_bag`, the
     library call, on the same operands; with `--old-gather-rows PATH`
     the earlier design through its C entry point in turns), `msda_patch_v6`
     (the walk over all levels in snake order; also N = 2
     with samples pushed across the border; its time split by level);
     each against its plain version in float32 and bfloat16, with the
     wrappers' gradients where the op has them. These kernels are also
     held at small shapes whose head rows align to 2 and to 4 bytes only
     (the staging words that D = 36 never takes); with `--old-dense-v3
     PATH` / `--old-patch-v6 PATH` (the earlier sources, copied outside
     the package with the `msda_common.cuh` they were built with) the
     earlier designs through their C entry points, timed in turns with
     this one's (`old_ms`, `entry_ms`, `ms_turns`);
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
     `Tracker` over the frames, per frame 6 window-layer calls (each
     launching the five stage kernels) and 6 decoder MSDA launches; then
     `BatchedTracker` over 8 sequences in lockstep; then the float32
     forward, card against CPU, over two frames (the second reuses the
     first's cached memory);
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
     against the CPU's float32 step and, ten times closer, its float64 step;
  train_fast: two-frame training of the full-width TPU-fast flagship in
     bfloat16 (B = 2 frame pairs, `train.yaml`'s training fields,
     `tpu_fast`'s warmup): 3 steps with finite losses, 12 decoder MSDA
     launches and 6 backward launches each and no window-layer kernel (the
     windowed encoder trains on its module path), step ms and peak memory;
     then an eval-mode forward of the trained model, whose every windowed
     layer launches kernel #8; then one float32 fast train step at 128x192,
     card against the CPU's float32 and float64 steps, as train_reference;
  checkpoint: `CheckpointManager` saves the train_fast state after its
     second step (seconds); a fresh model and state restored from it
     (seconds) hold every saved tensor bit for bit, and their third step
     with the same draws lands within the train phase's tolerance of the
     uninterrupted third step; the exact and the fast model with seeded
     weights through an `.npz` in the JAX layout into a fresh model give a
     bit-equal forward on one frame (file size, save and load seconds);
  evaluate: `evaluate` of the full-width exact and fast models over 4
     frames of moving rectangles with their boxes as ground truth
     (seconds per frame of the whole call, the 12 COCO statistics, launches
     per frame); 6 frames of `Tracker` on moving rectangles scored by
     `get_mot_accum` and `summarize` (MOTA, IDF1); `make_results` of the
     float32 eval forward on the card against the CPU's at 128x192.
  track_cli: the serving entry point, `cli.track.main` as a user calls it,
     over MOTChallenge-layout sequences of 1080x1920 PNG frames written
     with this script's own encoder (moving rectangles on a seeded
     texture, with gt.txt and det.txt), the full-width models saved as
     the CLI loads them (an `.npz` in the JAX layout and the train config
     beside it): the exact mode at B = 1 (2 sequences of 8 frames; its
     tracks against the port's `Tracker` on the same blobs; its Hz, the
     Tracker's frames/s and the host's read + preprocess ms a frame), the
     fast mode with `tpu.batch_sequences=8` (8 sequences of 4 frames in
     lockstep) and at B = 1, and the ground truth read back as results
     (MOTA = IDF1 = 1); every frame runs at 768x1344, whose shapes the
     msda and window phases hold (their `_cli` cases).
  train_cli: the training entry point, `cli.train.main` as a user calls
     it, over 2 MOTChallenge-layout sequences of 8 1080x1920 JPEGs
     converted by the port's `generate_coco_from_mot`: the full-width
     exact flagship in bf16 at B = 2 trained 2 epochs (batches in the
     608x1088, 800x1344 and, for an upright crop, 1088x1920 buckets), each
     validated (box AP of 4 frames,
     MOTA / IDF1 of the in-process tracking eval at 768x1344), resumed
     with `resume_optim` for a third, `eval_only` from its checkpoint (AP
     equal to the last validation's), then the fast mode one epoch (its
     validation launches kernel #8 at B = 2); step seconds, the share of
     a step spent waiting on the `Loader`, peak memory, the caches' entries
     and the memory left after each step, validation seconds a frame, the
     tracking eval's Hz and the launches by shape.
  variants: the single-frame Deformable DETR family at full width
     (`train.yaml` + `deformable tracking`: hidden 256, 8 heads of 32, 6+6
     layers, FFN 1024, 300 queries, box refinement, bf16), exact MSDA and
     with `tpu_fast` (the windowed encoder over the frame: kernel #8 at
     C = 256): `Tracker` over the frames at 800x1344, three train steps at
     B = 2 each (track queries twice, then detection), an eval forward of
     a training batch of the fast model (kernel #8 at B = 2), and one
     float32 forward card against CPU; the flagship with one encoder over
     both frames' 8 levels (3 `Tracker` frames, one train step); the exact
     flagship's train step in the train CLI's 1344x1344 bucket (an upright
     crop). Launches checked per frame and per step.
  agreement: the port's agreement tools briefly: the detection task at
     the `flagship` scale (416x544, B = 4, hidden 288, bf16), each arm 10
     steps and scored (mAP, AP50, cross-agreement; the fast arm's eval runs
     kernel #8 at 416x544 B = 4), and the tracking task at the `mid` scale
     (192x256, float32), each arm 25 steps, its `Tracker` over the held-out
     sequences (kernel #8's float32 kernel at B = 1) and scored (MOTA,
     IDF1); every arm's loss must fall and every score be a number.
  masks: the MOTS20 recipe (`cli.train with mots20`: vanilla DETR with
     the mask heads, softmax classes, hidden 256, FFN 2048, 100 queries,
     bf16) and `DeformableDETRSegm` (`deformable tracking` with `masks:
     true`), seeded weights: a synthetic MOTS20 layout (2 sequences of 4
     1080x1920 JPEGs, the ground truth as MOTS lines), `cli.track` over it
     with `Tracker` and `BatchedTracker` (150 track slots, 768x1344
     frames; the MOTS result files read back; Hz, read and preprocess ms a
     frame), the converter's MOTS mode, `cli.train` one epoch at B = 2
     with a mask evaluation and `eval_only` (box and mask AP), a recipe
     train step split into forward, criterion and backward with its peak
     memory, each model's forward with and without its mask heads; the
     Deformable masks model's `Tracker` over 800x1344 frames (kernels #1
     and #2 counted) and 2 train steps at B = 2 (the backward counted);
     each model's float32 forward card against CPU on `pred_masks`,
     `pred_logits` and `pred_boxes`.
  family: the rest of the Deformable DETR family at full width, seeded
     weights, bf16, 800x1344: two-stage (`train.yaml` + `deformable` +
     `two_stage`: hidden 256, 300 queries from 22,323 proposals, box
     refinement), its forward, 2 detection steps at B = 2 with the `_enc`
     losses, the criterion split (ms with and without `_enc`, the encoder
     match alone), `evaluate` on 2 frames, its float32 forward and train
     step card against CPU (against float64, the share of elements past
     the bound held to the CPU float32 step's own); the flagship with the
     dense decoder (`Tracker`, 2 steps, peak memory), with merged frame
     features (`Tracker`, a step) and with the exact encoder over the
     cached memory (`Tracker`: 6 `msda_patch` a frame); `deformable
     tracking` over ResNet-101 with 5 levels, and with DC5 (`Tracker` 3
     frames, a step each); the fast flagship at window side 16 (`Tracker`,
     `BatchedTracker` of 8 sequences x 3 frames, float32 card vs CPU, 4
     steps of the agreement tool's `fast_w16` arm and its eval). The
     `window` phase holds kernel #8 at 256-token windows at the shapes of
     these runs (`WINDOW_EXTRA`'s `w16_b1`, `w16_b8`, with each stage
     kernel, and `agree_w16`).
  panoptic: COCO panoptic and vanilla DETR's attention maps: the
     250-class `DETRSegm` (`train.yaml` + `mots20` with
     `dataset=coco_panoptic`, hidden 256, 100 queries, bf16, seeded
     weights, its class head made sure of one thing category) through
     `cli.train ... eval_only=true` over a synthetic panoptic root of 2
     800x1344 images at B = 2 (PQ / SQ / RQ, box and mask AP, its PNGs,
     seconds a frame); the MOTS20 recipe's model as an `AttentionMapDETR`
     in a `Tracker` over the frames at 800x1344 with `reset(hard=False)`
     halfway (ms a frame with and without maps; every map 25x42, finite);
     `cli.track ... generate_attention_maps=true` over a MOTS20 sequence
     at 768x1344 (Hz, rows). No kernel launch (vanilla DETR).
  train_extras: the exact flagship (bf16, B = 2, 800x1344, dropout 0.1):
     2 three-frame steps (`track_prev_prev_frame`: 36 `msda_patch`, 18
     `ms_deform_attn` with the previous frame's decoder at 600 queries, 18
     `msda_bwd`), 2 with `backprop_prev_frame` (54 `msda_bwd`); a two-frame
     step with `tpu.remat` and without from the same state and dropout
     draws, at 800x1344 and in the 1088x1920 bucket (the loss equal,
     grad_norm and the gradients within `msda_bwd`'s atomics' drift, step
     ms and peak memory both ways; 36 `msda_patch` with remat); one
     float32 three-frame step with backprop at 128x192, card against the
     CPU's float32 and float64 steps (`three_frame_reference`).
  Every MSDA call shape those six phases launch that no phase above holds
  (D = 32 at hidden 256; the 8-level joint encoder; 416x544 at B = 4; the
  mid scale; 1344x1344; 5 levels, DC5, the two-stage decoder's 300
  queries; the three-frame step's previous decoder at 600 queries and the
  backward of the previous frames' decoders at 500 and 600) is then held
  at that shape against the plain version, forward and backward, float32 and bfloat16, and timed
  (`kernel_phase_path_shapes`); the window phase holds kernel #8 at the
  new shapes (C = 256 at B = 1 and 2 with each stage kernel; 416x544 at B
  = 4; 192x256 float32 at B = 1: `WINDOW_EXTRA`).
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
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# MSDA shapes of the flagship tracking step at the 800x1344 bucket
LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))
BUCKET = (800, 1344)
VALID_HW = (750, 1333)         # a 1080x1920 video under the eval transform
# the serving entry point's frames (`cli.track`): a 1080x1920 frame resized
# by the eval transform to 750x1333 and padded to multiples of 64
CLI_BUCKET = (768, 1344)
CLI_LEVELS = ((96, 168), (48, 84), (24, 42), (12, 21))
# the training CLI's other buckets (`tpu.image_buckets`): its transforms
# take a 1080x1920 frame to at most 800 on the short side and 1333 on the
# long one, into 608x1088 where every frame of a batch fits it, and into
# 1088x1920 where a crop stands upright (taller than 800)
TRAIN_BUCKETS = {"608": ((608, 1088), ((76, 136), (38, 68), (19, 34),
                                       (10, 17))),
                 "1088": ((1088, 1920), ((136, 240), (68, 120), (34, 60),
                                         (17, 30)))}
M, D, P = 8, 36, 4
C, FF = 288, 1024
DEC_QUERIES = 650  # 150 track slots + 500 object queries
# training shapes: two frame pairs per step; the decoder sees 500 object
# queries + 111 track-query slots (100 objects + 11 false positives)
TRAIN_BATCH = 2
TRAIN_DEC_QUERIES = 611
TRAIN_PREV_QUERIES = 500       # the previous frame's forward: no track query
EVAL_DEC_QUERIES = 500         # `evaluate`'s forward: no track query, B = 1
# float32: the kernel and the plain version sum in different orders;
# bfloat16: the kernel rounds its float32 sum to bfloat16 once (half an
# ulp, at most 2^-8 relative) where the plain version returns float32
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -8)}
# window layer, kernel against plain on the same inputs. float32 (TF32
# off): both round nowhere, they sum in different orders through five
# products, a softmax and two LayerNorms: 1e-4 + 1e-4 |ref|. bfloat16, a
# stage ending in a LayerNorm (`stage_cases`): both round at the same
# points, so the outputs differ where a sum in another order flips a
# rounding upstream; a LayerNorm output's error scales with its row, not
# with itself, so the bound is three bfloat16 ulps (2^-7 relative) of
# max(1, |ref|). The whole bfloat16 layer is held by `window_bf16_held`.
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
                                           window_attn)
    return [msda.LIB, msda.BWD_LIB, window_attn.LIB, msda_dense.V4_LIB,
            msda_pallas.LIB]


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


def msda_inputs(shapes, lq, encoder, gen, n=1, ref_shapes=None, d=D):
    """value, locations, weights of `n` items on the card, `d` channels a
    head. Encoder queries (the tokens of `ref_shapes`, by default of
    `shapes`) sample near their own token (as a trained encoder does);
    decoder queries anywhere, some corners out of range."""
    dev = "cuda"
    s = sum(h * w for h, w in shapes)
    value = torch.randn(n, s, M, d, device=dev, generator=gen)
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


# the parent design of the forward kernel, for an A/B beside the kernel
# (`--old-msda-fwd`): its library, built with the others, or None
OLD_FWD_LIB = None


def old_fwd_lib(path: str):
    """A `CudaLib` of an earlier `csrc/msda_fwd.cu` (a copy outside the
    package, for an A/B), with that design's C entry point: a thread per
    channel of the M * D row, queries per block the last int."""
    import ctypes
    from trackformer_tpu_torch.ops.cuda_build import CudaLib
    return CudaLib(str(Path(path).resolve()), {"msda_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p])})


def raw_msda_fwd(fn, plan_args, value, shapes, loc, attn, out_f32):
    """`msda.msda_fwd_cuda`'s launch through the C entry point `fn` of a
    forward library, without the wrapper's checks and count, into the same
    kind of output. `plan_args` are the entry point's arguments between the
    output flag and the stream."""
    import ctypes
    n, s, m, d = value.shape
    lq, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    out = torch.empty(n, lq, m, d, device=value.device,
                      dtype=torch.float32 if out_f32 else value.dtype)
    hw = (ctypes.c_int * (2 * l))(*[int(v) for pair in shapes for v in pair])
    rc = fn(value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            n, s, lq, m, l, p, d, hw, int(value.dtype == torch.bfloat16),
            int(out_f32), *plan_args, torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"msda_fwd launch failed: cudaError {rc}")
    return out


def kernel_phase_msda(seed: int):
    """Every call shape of the gather kernel on the main paths, float32 and
    bfloat16, against the plain version within `TOL`, with the host's plan
    in each case line; times the kernel through the wrapper that the paths
    call (`ms`, as every kernel phase times it) and the plain version. With
    `--old-msda-fwd` it also times, through the C entry points, this
    design (`entry_ms`) and the earlier one (`old_ms`) in turns, this one
    at 2, 4 and 8 warps a block (`ms_by_warps`) and with every sample on
    one cell (`ms_one_cell`: every row read an L1 hit). Then three small
    calls for the kernel's other paths: D = 6 (bfloat16 one
    channel a lane, float32 8-byte words), a value tensor one element off
    its alignment (one channel a lane in both, two passes of 32 channels),
    and 16-byte words with 36 samples a head (two passes of 32 samples),
    samples outside [0, 1] on every level and levels one cell wide."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import dense_level_pallas
    from trackformer_tpu_torch.ops.msda_patch import msda_patch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dec_levels = LEVELS * 2
    # what `MSDA_DEC_SKIP` leaves to the gather kernel of a decoder call
    rest_levels = LEVELS[1:] * 2
    mid = LEVELS[1]
    s_enc = sum(h * w for h, w in LEVELS)
    f32, bf16 = torch.float32, torch.bfloat16

    def enc_kernel(v, lo, a):
        return msda_patch(v, LEVELS, lo, a)

    def dec_kernel(v, lo, a):
        return msda.ms_deform_attn(v, dec_levels, lo, a)

    # the serving entry point's frames: 768x1344
    s_cli = sum(h * w for h, w in CLI_LEVELS)
    cli_dec_levels = CLI_LEVELS * 2

    def cli_enc_kernel(v, lo, a):
        return msda_patch(v, CLI_LEVELS, lo, a)

    def cli_dec_kernel(v, lo, a):
        return msda.ms_deform_attn(v, cli_dec_levels, lo, a)

    def enc_kernel_of(shapes):
        return lambda v, lo, a: msda_patch(v, shapes, lo, a)

    def dec_kernel_of(shapes):
        return lambda v, lo, a: msda.ms_deform_attn(v, shapes, lo, a)

    def levels_kernel(shapes, out_f32=False):
        return lambda v, lo, a: msda.msda_cuda(v, shapes, lo, a,
                                               "ms_deform_attn", out_f32)

    def plain_of(shapes):
        return lambda v, lo, a: msda.ms_deform_attn_plain(v, shapes, lo, a)

    # (name, levels, queries per item, items, kernel, plain); decoder_b8 is
    # the lockstep step's decoder call, decoder_rest the six coarser levels
    # of a decoder call, launched as that route launches them: the float32
    # sums handed over unrounded, encoder_train and decoder_train the
    # training step's (two frame pairs, 500 object queries + 111
    # track-query slots), decoder_train_prev that of its previous-frame
    # forward (the object queries alone), decoder_eval that of a frame
    # through `evaluate` or a single-frame forward (the object queries
    # alone, B = 1); the _cli cases those of `cli.track` on 768x1344
    # frames (the exact encoder at B = 1, the decoder at B = 1 and in the
    # lockstep step at B = 8); the _608 and _1088 cases the training
    # step's in the train CLI's other buckets
    cases = [
        ("encoder", LEVELS, s_enc, 1, enc_kernel, plain_of(LEVELS)),
        ("decoder", dec_levels, DEC_QUERIES, 1, dec_kernel,
         plain_of(dec_levels)),
        ("decoder_b8", dec_levels, DEC_QUERIES, 8, dec_kernel,
         plain_of(dec_levels)),
        ("decoder_rest", rest_levels, DEC_QUERIES, 1,
         levels_kernel(rest_levels, True), plain_of(rest_levels)),
        ("encoder_train", LEVELS, s_enc, TRAIN_BATCH, enc_kernel,
         plain_of(LEVELS)),
        ("decoder_train", dec_levels, TRAIN_DEC_QUERIES, TRAIN_BATCH,
         dec_kernel, plain_of(dec_levels)),
        ("decoder_train_prev", dec_levels, TRAIN_PREV_QUERIES, TRAIN_BATCH,
         dec_kernel, plain_of(dec_levels)),
        ("decoder_eval", dec_levels, EVAL_DEC_QUERIES, 1, dec_kernel,
         plain_of(dec_levels)),
        ("encoder_cli", CLI_LEVELS, s_cli, 1, cli_enc_kernel,
         plain_of(CLI_LEVELS)),
        ("decoder_cli", cli_dec_levels, DEC_QUERIES, 1, cli_dec_kernel,
         plain_of(cli_dec_levels)),
        ("decoder_cli_b8", cli_dec_levels, DEC_QUERIES, 8, cli_dec_kernel,
         plain_of(cli_dec_levels)),
        ("single_level", (mid,), DEC_QUERIES, 1,
         lambda v, lo, a: dense_level_pallas(v, lo[:, :, :, 0],
                                             a[:, :, :, 0], *mid),
         lambda v, lo, a: msda.level_plain(v, lo[:, :, :, 0],
                                            a[:, :, :, 0], *mid)),
    ]
    for tag, (_, levels) in TRAIN_BUCKETS.items():
        both = levels * 2
        cases += [
            (f"encoder_train_{tag}", levels, sum(h * w for h, w in levels),
             TRAIN_BATCH, enc_kernel_of(levels), plain_of(levels)),
            (f"decoder_train_{tag}", both, TRAIN_DEC_QUERIES, TRAIN_BATCH,
             dec_kernel_of(both), plain_of(both)),
            (f"decoder_train_prev_{tag}", both, TRAIN_PREV_QUERIES,
             TRAIN_BATCH, dec_kernel_of(both), plain_of(both))]
    inputs = {}
    for name, shapes, lq, n, _, _ in cases:
        inputs[name] = msda_inputs(shapes, lq, name.startswith("encoder"),
                                   gen, n) + (0,)
    # (name, levels, queries, items, heads, channels, points, elements the
    # value lies off its buffer's start, sample range)
    small = [("d6", ((30, 40), (5, 7)), 3000, 2, 2, 6, 4, 0, (-0.1, 1.1)),
             ("d36_offset", ((30, 40), (5, 7)), 3000, 2, M, D, 4, 1,
              (-0.1, 1.1)),
             ("outside", ((30, 40), (15, 20), (1, 7), (3, 1)), 3000, 2, 4,
              32, 9, 0, (-0.3, 1.3))]
    for name, shapes, lq, n, m, d, p, offset, (lo, hi) in small:
        s = sum(h * w for h, w in shapes)
        value = torch.randn(n, s, m, d, device="cuda", generator=gen)
        loc = torch.rand(n, lq, m, len(shapes), p, 2, device="cuda",
                         generator=gen) * (hi - lo) + lo
        attn = torch.rand(n, lq, m, len(shapes), p, device="cuda",
                          generator=gen)
        outside = ((loc < 0) | (loc > 1)).any(-1).movedim(3, 0)
        check(bool(outside.flatten(1).any(1).all()),
              f"kernel {name}: a level without a sample outside [0, 1]")
        inputs[name] = (value, loc, attn, offset)
        cases.append((name, shapes, lq, n, levels_kernel(shapes),
                      plain_of(shapes)))
    # the word each case must take, float32 and bfloat16
    want_words = {"d6": (8, 0), "d36_offset": (0, 0), "outside": (16, 16)}
    fwd = msda.LIB.load().msda_fwd
    results = {}
    for name, shapes, lq, n, kern, plain in cases:
        value, loc, attn, offset = inputs.pop(name)
        m, d = value.shape[2:]
        out_f32 = name == "decoder_rest"
        for dtype in (f32, bf16):
            v = value.to(dtype)
            if offset:
                v = torch.cat([v.flatten()[:offset], v.flatten()])[offset:] \
                    .view(v.shape)
            # the wrapper's plan, and the same at 2, 4 and 8 warps a block
            plans = {w: msda.fwd_plan(n, lq, m, d, v.element_size(),
                                      v.data_ptr(), w) for w in (2, 4, 8)}
            plan = msda.fwd_plan(n, lq, m, d, v.element_size(), v.data_ptr())
            check(plan.word == want_words.get(
                name, (16, 8))[dtype == bf16],
                f"kernel {name} {dtype}: plan {plan}")

            def new_kernel(warps=plan.warps, lo=loc):
                pl = plans[warps]
                return raw_msda_fwd(fwd, (pl.word, pl.warps, *pl.grid), v,
                                    shapes, lo, attn, out_f32)

            def old_kernel():
                return raw_msda_fwd(OLD_FWD_LIB.load().msda_fwd, (4,), v,
                                    shapes, loc, attn, out_f32)
            atol, rtol = TOL[dtype]
            with torch.no_grad():
                got = kern(v, loc, attn)
                check(got.dtype == (f32 if out_f32 else dtype),
                      f"kernel {name} {dtype}: output in {got.dtype}")
                got = got.float().reshape(n, lq, m * d)
                torch.cuda.synchronize()
                want = plain(v, loc, attn).reshape(n, lq, m * d)
                err = (got - want).abs()
                ok = bool((err <= atol + rtol * want.abs()).all())
                max_abs = err.max().item()
                max_rel = (err / want.abs().clamp(min=1e-3)).max().item()
                raw_ok = bool(torch.equal(new_kernel().float().reshape(
                    n, lq, m * d), got))
                ms = time_ms(lambda: kern(v, loc, attn), 20, INNER)
                plain_ms = time_ms(lambda: plain(v, loc, attn), 5, INNER)
                ab = dict(entry_ms="not measured", old_ms="not measured")
                if OLD_FWD_LIB is not None:
                    old_err = (old_kernel().float().reshape(n, lq, m * d)
                               - want).abs()
                    check(bool((old_err <= atol + rtol * want.abs()).all()),
                          f"kernel {name} {dtype}: the earlier design is out "
                          f"of tolerance")
                    new_t, old_t = [], []
                    for _ in range(2):     # in turns: new, old, new, old
                        new_t.append(time_ms(new_kernel, 10, INNER))
                        old_t.append(time_ms(old_kernel, 10, INNER))
                    # this design at other block sizes (what FWD_WARPS rests
                    # on), and with every sample on one cell, so that every
                    # row read is an L1 hit (what the value reads cost)
                    by_warps = {w: round(time_ms(lambda: new_kernel(w), 10,
                                                 INNER), 4)
                                for w in (2, 4, 8) if name not in want_words}
                    one_cell = torch.full_like(loc, 0.5)
                    one_cell_ms = time_ms(lambda: new_kernel(lo=one_cell),
                                          10, INNER)
                    ab = dict(entry_ms=f"{statistics.mean(new_t):.4f}",
                              old_ms=f"{statistics.mean(old_t):.4f}",
                              ms_by_warps=json.dumps(by_warps,
                                                     separators=(",", ":")),
                              ms_one_cell=f"{one_cell_ms:.4f}")
            bound_ms, bound_by = msda_bound(v, loc, attn,
                                            4 if out_f32 else None)
            phase("kernel", case=name, dtype=str(dtype).split(".")[-1],
                  items=n, lq=lq, levels=len(shapes), heads=m, channels=d,
                  points=loc.shape[4], word=plan.word, warps=plan.warps,
                  max_abs_err=f"{max_abs:.3e}",
                  max_rel_err=f"{max_rel:.3e}",
                  tol=f"{atol:g}+{rtol:g}*|ref|", ms=f"{ms:.4f}", **ab,
                  plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
                  bound_by=bound_by, ok=ok and raw_ok)
            check(ok, f"kernel {name} {dtype} out of tolerance: "
                      f"max abs err {max_abs}")
            check(raw_ok, f"kernel {name} {dtype}: the C entry point's "
                          f"output differs from the wrapper's")
            results[(name, dtype)] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return results


def window_inputs(batch: int, shift: bool, dtype, gen, bucket=BUCKET,
                  levels=LEVELS, c=C, valid_hw=VALID_HW, win=8):
    """The windowed layer's inputs at the fast mode's shapes: random tokens
    and positions of width `c`, and the key padding that `window_context`
    makes from the level masks of the 750x1333 region in the 800x1344
    bucket (or of `valid_hw` in `bucket`, whose feature levels are
    `levels`), in windows of side `win`."""
    from trackformer_tpu_torch.models.backbone import downsample_mask
    from trackformer_tpu_torch.models.windowed_encoder import (
        pad_hw, window_context, window_partition)
    from trackformer_tpu_torch.structures import FrameBatch

    dev = "cuda"
    img = torch.zeros(batch, *bucket, 3, device=dev)
    mask = FrameBatch.from_images(
        img, torch.tensor([valid_hw] * batch)).mask
    masks = [downsample_mask(mask, hw) for hw in levels]
    poses = [torch.randn(batch, h, w, c, device=dev, generator=gen)
             for h, w in levels]
    pw, kp = window_context(poses, masks, win, shift, dtype)
    xw = torch.cat([window_partition(pad_hw(
        torch.randn(batch, h, w, c, device=dev, generator=gen), win)[0], win)
        for h, w in levels]).to(dtype)
    # windows whose every slot lies in the padding (un-masked above)
    full_pad = 0
    for m in masks:
        mf = m[..., None].float()
        if shift:
            mf = torch.roll(mf, (-(win // 2), -(win // 2)), (1, 2))
        mf = pad_hw(mf - 1.0, win)[0] + 1.0
        full_pad += int((window_partition(mf, win)[..., 0] > 0.5).all(1)
                        .sum())
    return xw, pw.contiguous(), kp.contiguous(), full_pad


# The whole bfloat16 layer: five stages, each rounding, chained through two
# LayerNorms, carry each implementation several ulps from the exact layer,
# and two implementations that sum in different orders can sit on either
# side of it. So the kernel is held to the plain version's own accuracy:
# against the plain version in float64 on the same bfloat16 inputs and
# weights (the exact layer), in bfloat16 ulps of max(1, |exact|), its
# largest error may exceed the plain bfloat16 version's by at most one ulp
# (the rounding of an output), and its mean error the plain version's by
# at most a tenth of an ulp, so that an error on every element fails even
# where it stays under the largest. At the 800x1344 bucket the kernel is
# also held within `window_tol`'s three ulps of the plain version on every
# element; at the 768x1344 frames of `cli.track` that rule does not hold
# even for the plain version against the same stages' plain chain
# (`window_layer_staged_plain`, rounding where the kernels round), and it
# is a reading there.
WINDOW_BF16_SLACK_ULPS = 1.0
WINDOW_BF16_MEAN_SLACK_ULPS = 0.1


def window_layer_float64(xw, pw, kp, layer) -> torch.Tensor:
    """The plain version in float64 on the same (bfloat16-valued) inputs
    and weights: the exact layer, up to float64's rounding."""
    import copy
    from trackformer_tpu_torch.ops.window_attn import window_layer_plain

    layer64 = copy.deepcopy(layer).double()
    layer64.__dict__.pop("_window_layer_packs", None)
    return window_layer_plain(xw.double(), pw.double(), kp, layer64)


def window_bf16_held(got, want, xw, pw, kp, layer, three_ulp: bool) -> dict:
    """The bfloat16 layer's readings against the exact layer: the kernel's
    and the plain version's largest and mean errors in ulps of
    max(1, |exact|), and whether the kernel is within
    `WINDOW_BF16_SLACK_ULPS` of the plain version's largest and
    `WINDOW_BF16_MEAN_SLACK_ULPS` of its mean (and, with `three_ulp`,
    within `window_tol` of the plain version on every element); beside
    them the three-ulp rule's ratio between the kernel and the plain
    version, and between the plain version and its staged plain chain."""
    from trackformer_tpu_torch.ops.window_attn import (
        packed_weights, window_layer_staged_plain)

    exact = window_layer_float64(xw, pw, kp, layer)
    ulp = 2.0 ** -7 * exact.abs().clamp(min=1.0)
    kernel_err = (got.double() - exact).abs() / ulp
    plain_err = (want.double() - exact).abs() / ulp
    del exact, ulp
    kernel_ulps, plain_ulps = kernel_err.max().item(), plain_err.max().item()
    kernel_mean, plain_mean = (kernel_err.mean().item(),
                               plain_err.mean().item())
    del kernel_err, plain_err
    staged = window_layer_staged_plain(
        xw, pw, kp, packed_weights(layer, xw.dtype)).float()
    _, tol = window_tol(torch.bfloat16, want)
    ratio = ((got - want).abs() / tol).max().item()
    return dict(
        kernel_ulps_vs_float64=kernel_ulps,
        plain_ulps_vs_float64=plain_ulps,
        kernel_mean_ulps_vs_float64=kernel_mean,
        plain_mean_ulps_vs_float64=plain_mean,
        ok=(kernel_ulps <= plain_ulps + WINDOW_BF16_SLACK_ULPS
            and kernel_mean <= plain_mean + WINDOW_BF16_MEAN_SLACK_ULPS
            and (ratio <= 1.0 or not three_ulp)),
        three_ulp_ratio_kernel_plain=ratio,
        three_ulp_ratio_staged_plain=((staged - want).abs()
                                      / tol).max().item())


def window_layer_module(gen, dtype, c=C):
    """A full-width `WindowedEncoderLayer` (d_model `c`) with seeded random
    weights: lecun-normal matrices, small random biases and norm affines,
    so every term of the layer carries signal."""
    from trackformer_tpu_torch.models.windowed_encoder import \
        WindowedEncoderLayer

    layer = WindowedEncoderLayer(c, M, FF, 8, shift=False).cuda()
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
    return bound(n_bytes, flops,
                 FP32_FLOPS if xw.dtype == torch.float32 else BF16_FLOPS)


# the parent design of the window layer, for an A/B beside the kernels
# (`--old-window-layer`): its library, built with the others, or None
OLD_WINDOW_LIB = None


def old_window_lib(path: str):
    """A `CudaLib` of an earlier `csrc/window_layer_fwd.cu` (a copy outside
    the package, for an A/B) with that design's C entry point: a block per
    window, the q|k|v weights in the per-head layout padded to 48."""
    import ctypes
    from trackformer_tpu_torch.ops.cuda_build import CudaLib
    return CudaLib(str(Path(path).resolve()), {"window_layer_fwd": (
        ctypes.c_int, [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
        + [ctypes.c_void_p])})


def old_window_layer(xw, pw, kp, layer):
    """The earlier design (`--old-window-layer`) in bfloat16, through its C
    entry point, on the weights packed as it takes them."""
    from trackformer_tpu_torch.ops.window_attn import (N_HEADS, WS,
                                                       packed_weights)
    weights = packed_weights(layer, xw.dtype, padded=True)
    out = torch.empty_like(xw)
    rc = OLD_WINDOW_LIB.load().window_layer_fwd(
        xw.data_ptr(), pw.data_ptr(), kp.data_ptr(),
        *[w.data_ptr() for w in weights], out.data_ptr(), xw.shape[0], WS,
        C, N_HEADS, FF, 1, torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"old window_layer_fwd launch failed: cudaError {rc}")
    return out


def stage_cases(xw, pw, kp, weights):
    """Each stage kernel of the bfloat16 layer with its inputs, its plain
    version and the plain output on those inputs: (name, kernel call,
    plain call, plain output, elementwise tolerance text, tolerance,
    (bytes, flops) of its bound). Every stage gets the plain chain's
    inputs, so each is held alone. Tolerances: a product rounded, its bias
    added and rounded, can differ by one bfloat16 ulp (<= 2^-7 relative)
    at each of the two roundings where the float32 sums, taken in other
    orders, straddle a rounding point: 2^-7 (2 |ref| + |b|). Attention:
    each probability can differ by an ulp, so the sum over the keys by
    2^-7 max |v| of the window's head, and the rounded output by 2^-7
    |ref|. The stages ending in a LayerNorm: the whole layer's bound
    (`window_tol`), whose last step they are."""
    from trackformer_tpu_torch.ops import window_attn as wa

    nw, ws, c = xw.shape
    r = nw * ws
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = weights
    ff = w1.shape[1]
    x, p = xw.reshape(r, c), pw.reshape(r, c)
    qkv = wa.qkv_plain(x, p, wqkv, bqkv)
    a = wa.attn_plain(qkv, kp)
    x1 = wa.proj_ln_plain(a, wo, bo, x, g1, be1)
    h = wa.ffn1_plain(x1, w1, b1)
    out = wa.ffn2_ln_plain(h, w2, b2, x1, g2, be2)
    u = 2.0 ** -7

    def product_tol(ref, bias):
        return "2^-7*(2|ref|+|b|)", u * (2 * ref.float().abs()
                                         + bias.float().abs())

    d = c // M
    vmax = qkv[:, 2 * c:].float().abs().view(nw, ws, M, d).amax(
        (1, 3), keepdim=True).expand(nw, ws, M, d).reshape(r, c)
    es = 2
    return [
        ("window_layer_qkv", lambda: wa.qkv_cuda(x, p, wqkv, bqkv),
         lambda: wa.qkv_plain(x, p, wqkv, bqkv), qkv,
         *product_tol(qkv, bqkv),
         ((2 * r * c + c * 3 * c + 3 * c + r * 3 * c) * es,
          2 * r * c * 3 * c)),
        ("window_layer_attn", lambda: wa.attn_cuda(qkv, kp),
         lambda: wa.attn_plain(qkv, kp), a, "2^-7*(|ref|+max|v| of the "
         "window's head)", u * (a.float().abs() + vmax),
         ((r * 3 * c + r * c) * es + kp.numel(), 2 * 2 * r * ws * c)),
        ("window_layer_proj_ln",
         lambda: wa.proj_ln_cuda(a, wo, bo, x, g1, be1),
         lambda: wa.proj_ln_plain(a, wo, bo, x, g1, be1), x1,
         *window_tol(torch.bfloat16, x1.float()),
         ((3 * r * c + c * c + 3 * c) * es, 2 * r * c * c)),
        ("window_layer_ffn1", lambda: wa.ffn1_cuda(x1, w1, b1),
         lambda: wa.ffn1_plain(x1, w1, b1), h, *product_tol(h, b1),
         ((r * c + c * ff + ff + r * ff) * es, 2 * r * c * ff)),
        ("window_layer_ffn2_ln",
         lambda: wa.ffn2_ln_cuda(h, w2, b2, x1, g2, be2),
         lambda: wa.ffn2_ln_plain(h, w2, b2, x1, g2, be2), out,
         *window_tol(torch.bfloat16, out.float()),
         ((r * ff + 2 * r * c + ff * c + 3 * c) * es, 2 * r * ff * c)),
    ]


def stage_library(name, qkv, kp):
    """One PyTorch call that computes the stage's function, where there is
    one (attention: `scaled_dot_product_attention` with a float mask, per
    window and head), else None; a yardstick of time only."""
    if name != "window_layer_attn":
        return None
    from torch.nn import functional as F
    nw, ws = kp.shape
    d = qkv.shape[1] // (3 * M)
    q, k, v = qkv.view(nw, ws, 3, M, d).permute(2, 0, 3, 1, 4).unbind(0)
    mask = torch.zeros(nw, 1, 1, ws, dtype=qkv.dtype, device=qkv.device)
    mask = mask.masked_fill(kp[:, None, None, :], torch.finfo(qkv.dtype).min)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def kernel_phase_window(seed: int):
    """The layer's kernels against its plain version at the shapes of both
    fast paths (B = 1: 380 windows, B = 8: 3,040) and of the train CLI's
    validation (B = 2: 760), float32 and bfloat16,
    both shift parities; each of the five bfloat16 stage kernels against
    its plain stage at B = 8 (`stage_cases`), with its time, bound and the
    blocks per SM the card grants it; times of the layer through the
    wrapper, the plain version, the library composition and, with
    `--old-window-layer`, the earlier design, in bfloat16 at shift 0. The
    same again at the shapes of `cli.track`'s 768x1344 frames (B = 1: 342
    windows, B = 8: 2,736), results under ("cli", B) and, for the stage
    kernels at B = 8, ("cli", name). The wrapper packs a layer's weights
    once per dtype (`packed_weights`), so after the first call the time is
    that of the launches; the packing is timed apart."""
    from trackformer_tpu_torch.ops.window_attn import (
        fused_window_layer, pack_weights, window_layer_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # the plain version's bf16 products summed in float32 throughout, as
    # the kernels sum them
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    bf16 = torch.bfloat16
    errs, results = {}, {}
    try:
        for dtype, cli in ((torch.float32, False), (bf16, False),
                           (torch.float32, True), (bf16, True)):
            layer = window_layer_module(gen, dtype)
            shapes = (CLI_BUCKET, CLI_LEVELS) if cli else (BUCKET, LEVELS)
            image = "x".join(map(str, shapes[0]))
            for batch in ((1, 8) if cli else (1, 2, 8)):
                key = ("cli", batch) if cli else batch
                for shift in (False, True):
                    xw, pw, kp, full_pad = window_inputs(batch, shift, dtype,
                                                         gen, *shapes)
                    with torch.no_grad():
                        got = fused_window_layer(xw, pw, kp, layer).float()
                        torch.cuda.synchronize()
                        want = window_layer_plain(xw, pw, kp, layer).float()
                        held = None if dtype != bf16 else \
                            window_bf16_held(got, want, xw, pw, kp, layer,
                                             three_ulp=not cli)
                    err = (got - want).abs()
                    finite = bool(torch.isfinite(got).all())
                    max_abs = err.max().item()
                    if held is None:
                        tol_text, tol = window_tol(dtype, want)
                        ok = bool((err <= tol).all()) and finite
                        worst = (err / tol).max().item()
                        readings = dict(err_over_tol=f"{worst:.3f}")
                    else:
                        tol_text = (
                            f"max,mean ulps_vs_float64(kernel)<=plain's+"
                            f"{WINDOW_BF16_SLACK_ULPS:g},"
                            f"{WINDOW_BF16_MEAN_SLACK_ULPS:g}"
                            + ("" if cli else "; |kernel-plain|<="
                               + window_tol(bf16, want)[0]))
                        ok = held.pop("ok") and finite
                        readings = {k: f"{v:.3f}" for k, v in held.items()}
                    phase("kernel", case="window_layer",
                          dtype=str(dtype).split(".")[-1], batch=batch,
                          image=image, shift=int(shift), windows=xw.shape[0],
                          fully_padded_windows=full_pad,
                          max_abs_err=f"{max_abs:.3e}", **readings,
                          tol=json.dumps(tol_text), finite=finite, ok=ok)
                    # the 768x1344 frame's levels pad no window whole
                    check(full_pad > 0 or shift or cli,
                          "no fully-padded window at shift 0")
                    check(ok, f"kernel window_layer {dtype} {image} "
                              f"B={batch} shift {shift} out of tolerance: "
                              f"max abs err {max_abs}")
                    errs[(dtype, key, shift)] = max_abs
                    if dtype != bf16 or shift:
                        continue
                    if batch == 8:
                        stages = window_stage_phase(xw, pw, kp, layer, image)
                        results.update({(("cli", k) if cli else k): v
                                        for k, v in stages.items()})
                    with torch.no_grad():
                        results[key] = window_times(xw, pw, kp, layer)
                        results[key]["weight_packing_ms"] = time_ms(
                            lambda: pack_weights(layer, bf16), 10, INNER)
                    bound_ms, bound_by = window_bound(xw, kp, layer)
                    results[key].update(bound_ms=bound_ms,
                                        bound_by=bound_by, library_ms=None)
                    phase("kernel", case="window_layer", dtype="bfloat16",
                          batch=batch, image=image, windows=xw.shape[0],
                          **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                             for k, v in results[key].items()})
        for key in (1, 2, 8, ("cli", 1), ("cli", 8)):
            results[key]["max_abs_err"] = max(errs[(bf16, key, False)],
                                              errs[(bf16, key, True)])
        results.update(window_extra_cases(gen))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    return results


# The window layer at the shapes this slice adds, (key, d_model, B, bucket,
# levels, valid region, dtypes, the stage kernels too): the single-frame
# family's C = 256 (8 heads of 32) at B = 1 and 2 in the 800x1344 bucket
# (its `Tracker` and a batch of its training's eval forward), and at C =
# 288 the agreement runs' frames: the flagship detection task's 416x544 at
# B = 4 in bfloat16 (its held-out scenes, in chunks of 4) and the mid
# tracking task's 192x256 at B = 1 in float32 (its `Tracker`); then kernel
# #8 at window side 16 (256 tokens a window, the last field; 8 elsewhere):
# the fast flagship's `Tracker` (B = 1) and `BatchedTracker` (B = 8) at
# 800x1344, each stage kernel at both, and the agreement tool's `fast_w16`
# arm's eval at 416x544, B = 4
AGREE_BUCKET, AGREE_LEVELS = (416, 544), ((52, 68), (26, 34), (13, 17),
                                          (7, 9))
MID_BUCKET, MID_LEVELS = (192, 256), ((24, 32), (12, 16), (6, 8), (3, 4))
WINDOW_EXTRA = [
    (("c256", 1), 256, 1, BUCKET, LEVELS, VALID_HW,
     (torch.float32, torch.bfloat16), False),
    (("c256", 2), 256, 2, BUCKET, LEVELS, VALID_HW,
     (torch.float32, torch.bfloat16), True),
    (("agree", 4), C, 4, AGREE_BUCKET, AGREE_LEVELS, AGREE_BUCKET,
     (torch.float32, torch.bfloat16), False),
    (("agree_mid", 1), C, 1, MID_BUCKET, MID_LEVELS, MID_BUCKET,
     (torch.float32,), False),
    (("w16_b1", 1), C, 1, BUCKET, LEVELS, VALID_HW,
     (torch.float32, torch.bfloat16), True, 16),
    (("w16_b8", 8), C, 8, BUCKET, LEVELS, VALID_HW,
     (torch.float32, torch.bfloat16), True, 16),
    (("agree_w16", 4), C, 4, AGREE_BUCKET, AGREE_LEVELS, AGREE_BUCKET,
     (torch.bfloat16,), False, 16),
]


def window_extra_cases(gen) -> dict:
    """`WINDOW_EXTRA`: each shape's layer kernels against the plain
    version, both shift parities, in each of its dtypes (bfloat16 by
    `window_bf16_held`, its three-ulp rule in the 800x1344 bucket as at C =
    288; float32 by `window_tol`); the bfloat16 stage kernels one by one
    where asked; times of the layer, its plain version and the library
    composition in the case's last dtype at shift 0 -> results by key."""
    from trackformer_tpu_torch.ops.window_attn import (fused_window_layer,
                                                       window_layer_plain)
    bf16 = torch.bfloat16
    results = {}
    for key, c, batch, bucket, levels, valid, dtypes, stages, *win in \
            WINDOW_EXTRA:
        win = win[0] if win else 8
        image = "x".join(map(str, bucket))
        worst = 0.0
        for dtype in dtypes:
            layer = window_layer_module(gen, dtype, c)
            for shift in (False, True):
                xw, pw, kp, full_pad = window_inputs(
                    batch, shift, dtype, gen, bucket, levels, c, valid, win)
                with torch.no_grad():
                    got = fused_window_layer(xw, pw, kp, layer).float()
                    torch.cuda.synchronize()
                    want = window_layer_plain(xw, pw, kp, layer).float()
                    # the three-ulp rule holds at window side 8 in the
                    # 800x1344 bucket; at side 16 the plain version breaks
                    # it against its own staged chain (a reading there, as
                    # at cli.track's frames)
                    three_ulp = bucket == BUCKET and win == 8
                    held = None if dtype != bf16 else window_bf16_held(
                        got, want, xw, pw, kp, layer, three_ulp=three_ulp)
                err = (got - want).abs()
                finite = bool(torch.isfinite(got).all())
                if held is None:
                    tol_text, tol = window_tol(dtype, want)
                    ok = bool((err <= tol).all()) and finite
                    readings = dict(
                        err_over_tol=f"{(err / tol).max().item():.3f}")
                else:
                    tol_text = (
                        f"max,mean ulps_vs_float64(kernel)<=plain's+"
                        f"{WINDOW_BF16_SLACK_ULPS:g},"
                        f"{WINDOW_BF16_MEAN_SLACK_ULPS:g}"
                        + ("; |kernel-plain|<=" + window_tol(bf16, want)[0]
                           if three_ulp else ""))
                    ok = held.pop("ok") and finite
                    readings = {k: f"{v:.3f}" for k, v in held.items()}
                max_abs = err.max().item()
                worst = max(worst, max_abs)
                phase("kernel", case="window_layer",
                      dtype=str(dtype).split(".")[-1], channels=c,
                      batch=batch, image=image, window_side=win,
                      shift=int(shift), windows=xw.shape[0],
                      fully_padded_windows=full_pad,
                      max_abs_err=f"{max_abs:.3e}", **readings,
                      tol=json.dumps(tol_text), finite=finite, ok=ok)
                check(ok, f"kernel window_layer C={c} {dtype} {image} "
                          f"B={batch} window {win} shift {shift} out of "
                          f"tolerance: max abs err {max_abs}")
                if shift or dtype != dtypes[-1]:
                    continue
                if stages:
                    results.update({(key[0], name): v for name, v in
                                    window_stage_phase(xw, pw, kp, layer,
                                                       image).items()})
                with torch.no_grad():
                    times = window_times(xw, pw, kp, layer)
                bound_ms, bound_by = window_bound(xw, kp, layer)
                results[key] = dict(times, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=None)
                phase("kernel", case="window_layer",
                      dtype=str(dtype).split(".")[-1], channels=c,
                      batch=batch, image=image, window_side=win,
                      windows=xw.shape[0],
                      **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                         for k, v in results[key].items()})
        results[key]["max_abs_err"] = worst
    return results


def window_times(xw, pw, kp, layer) -> dict:
    """bf16 ms of the layer through the wrapper (`ms`), the plain version,
    the library composition and, with `--old-window-layer`, the earlier
    design (`old_ms`), that one and this in turns: new, old, new, old."""
    from trackformer_tpu_torch.ops.window_attn import (fused_window_layer,
                                                       window_layer_plain)
    new = lambda: fused_window_layer(xw, pw, kp, layer)  # noqa: E731
    times = {"ms": time_ms(new, 20, INNER)}
    if OLD_WINDOW_LIB is not None:
        old = lambda: old_window_layer(xw, pw, kp, layer)  # noqa: E731
        got = old().float()
        want = new().float()
        err = (got - want).abs()
        _, tol = window_tol(torch.bfloat16, want)
        check(bool((err <= 2 * tol).all()), "the earlier window layer "
              "design differs from this one")
        turns = [time_ms(old, 20, INNER), time_ms(new, 20, INNER),
                 time_ms(old, 20, INNER)]
        times.update(old_ms=statistics.median([turns[0], turns[2]]),
                     ms_turns="[" + ",".join(
                         f"{t:.4f}" for t in [times["ms"], turns[0],
                                              turns[1], turns[2]]) + "]")
        times["ms"] = statistics.median([times["ms"], turns[1]])
    else:
        times["old_ms"] = "not measured"
    times["plain_ms"] = time_ms(lambda: window_layer_plain(xw, pw, kp, layer),
                                10, INNER)
    times["library_composition_ms"] = time_ms(
        lambda: window_layer_library(xw, pw, kp, layer), 10, INNER)
    return times


def window_stage_phase(xw, pw, kp, layer, image: str) -> dict:
    """Each bfloat16 stage kernel against its plain stage at this call
    (`stage_cases`): one case line each with its error, time, plain time,
    library time where one call computes it, bound and blocks per SM; the
    results by stage name."""
    from trackformer_tpu_torch.ops import window_attn as wa

    weights = wa.packed_weights(layer, xw.dtype)
    occupancy = wa.stage_occupancy(xw.shape[2], xw.shape[1])
    out = {}
    with torch.no_grad():
        cases = stage_cases(xw, pw, kp, weights)
        qkv = cases[0][3]
        for name, kernel, plain, want, tol_text, tol, (nb, nf) in cases:
            got = kernel().float()
            torch.cuda.synchronize()
            err = (got - want.float()).abs()
            finite = bool(torch.isfinite(got).all())
            ok = bool((err <= tol).all()) and finite
            ms = time_ms(kernel, 20, INNER)
            plain_ms = time_ms(plain, 5, 1)
            lib = stage_library(name, qkv, kp)
            lib_ms = None if lib is None else time_ms(lib, 20, INNER)
            bound_ms, bound_by = bound(nb, nf, BF16_FLOPS)
            out[name] = dict(max_abs_err=err.max().item(), ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms,
                             blocks_per_sm=occupancy[name][0])
            phase("kernel", case=name, dtype="bfloat16", channels=xw.shape[2],
                  image=image, window_tokens=xw.shape[1], rows=want.shape[0],
                  max_abs_err=f"{err.max().item():.3e}",
                  err_over_tol=f"{(err / tol).max().item():.3f}",
                  tol=json.dumps(tol_text), ms=f"{ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}",
                  library_ms="null" if lib_ms is None else f"{lib_ms:.4f}",
                  bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                  share_of_bound=f"{bound_ms / ms:.3f}",
                  blocks_per_sm=occupancy[name][0],
                  smem_bytes=occupancy[name][1], finite=finite, ok=ok)
            check(ok, f"kernel {name} out of tolerance: max abs err "
                      f"{err.max().item()}")
            check(occupancy[name][0] >= 1,
                  f"{name}: the card grants no block per SM")
    return out


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
    levels), both again in the train CLI's 608x1088 and 1088x1920 buckets
    (S = 13,736 and 43,350) and the four single-level calls that route v2 makes per encoder
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
    for tag, (_, levels) in TRAIN_BUCKETS.items():
        cases += [(f"encoder_{tag}", levels, sum(h * w for h, w in levels),
                   True, M, D, None),
                  (f"decoder_{tag}", levels * 2, TRAIN_DEC_QUERIES, False, M,
                   D, None)]
    cases += [(f"encoder_l{i}", (hw,), s_enc, True, M, D, None)
              for i, hw in enumerate(LEVELS)]
    cases += [("unaligned_d6", ((30, 40), (5, 7)), 3000, False, 2, 6,
               ((1,), False)),
              ("mixed_budget", ((120, 180), (20, 30)), 4000, False, M, D,
               ((1,), True))]
    results = {}
    for name, shapes, lq, encoder, m, d, want_plan in cases:
        if (m, d) == (M, D):
            value, loc, attn = msda_inputs(
                shapes, lq, encoder, gen, TRAIN_BATCH,
                ref_shapes=shapes if name.startswith("encoder_") and len(
                    shapes) > 1 else LEVELS)
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


# MSDA shapes launched by the paths this slice adds (the `variants` and
# `agreement` phases), by key, and the phases that launched them
NEW_SHAPES: dict = {}


def note_new_shapes(tag: str) -> None:
    """Each MSDA shape the run launched (since the last reset) noted under
    `tag` for `kernel_phase_path_shapes`."""
    from trackformer_tpu_torch.ops import msda
    for key in msda.launch_shapes():
        NEW_SHAPES.setdefault(key, set()).add(tag)


def record_new_path(tag: str) -> None:
    """`record_path` and `note_new_shapes`."""
    note_new_shapes(tag)
    record_path()


def kernel_phase_path_shapes(keys, seed: int) -> dict:
    """Each MSDA call shape of `keys` ((wrapper, items, queries, levels,
    channels), as the wrappers count them) held where the paths launched
    it: the forward through its wrapper (`msda_patch` for an encoder call,
    `ms_deform_attn` for a decoder call) against `ms_deform_attn_plain`
    within `TOL`, the backward (`msda_bwd_cuda`) against autograd through
    the plain version within `grad_tol`, float32 and bfloat16, on inputs
    drawn as the msda phases draw them (encoder queries near their own
    token, decoder queries anywhere, samples past the border); times in
    bfloat16 beside the plain version's and the bound -> results by key."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_patch import msda_patch

    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    results = {}
    for key in sorted(keys, key=str):
        name, n, lq, shapes, d = key
        s = sum(h * w for h, w in shapes)
        encoder = lq == s
        value, loc, attn = msda_inputs(shapes, lq, encoder, gen, n, d=d)
        if name == "msda_bwd" and encoder:
            loc[:, ::16] = loc[:, ::16] * 1.2 - 0.1
        worst, ok = 0.0, True
        for dtype in (torch.float32, torch.bfloat16):
            v = value.to(dtype)
            if name == "msda_bwd":
                g = torch.randn(n, lq, M, d, device="cuda",
                                generator=gen).to(dtype)
                vv, lo, at = (t.clone().requires_grad_(True)
                              for t in (v, loc, attn))
                args = (g, v, shapes, loc, attn)
                got = msda.msda_bwd_cuda(*args)
                torch.cuda.synchronize()
                out = msda.ms_deform_attn_plain(vv, shapes, lo, at).to(dtype)
                want = torch.autograd.grad(out, (vv, lo, at), g,
                                           retain_graph=True)
                errs = []
                for i, (a, b) in enumerate(zip(got, want)):
                    err = (a.float() - b.float()).abs()
                    tol = grad_tol(dtype, b.float(), i == 0)
                    ok = ok and bool((err <= tol).all()) \
                        and bool(torch.isfinite(a).all())
                    errs.append((err / tol).max().item())
                    worst = max(worst, err.max().item())
                readings = dict(err_over_tol=f"{max(errs):.3f}")

                def kernel():
                    return msda.msda_bwd_cuda(*args)

                def plain():
                    return torch.autograd.grad(out, (vv, lo, at), g,
                                               retain_graph=True)
                bound_ms, bound_by = msda_bwd_bound(v, loc, attn,
                                                    g.element_size())
                tol_text = "1e-5*max(1,max|ref|)+1e-5*|ref| (bf16 " \
                           "grad_value: 2^-7*|ref|)"
            else:
                def kernel():
                    if name == "msda_patch":
                        return msda_patch(v, shapes, loc, attn)
                    return msda.ms_deform_attn(v, shapes, loc, attn)

                def plain():
                    return msda.ms_deform_attn_plain(v, shapes, loc, attn)
                with torch.no_grad():
                    a = kernel().float().reshape(n, lq, M * d)
                    torch.cuda.synchronize()
                    b = plain().float().reshape(n, lq, M * d)
                atol, rtol = TOL[dtype]
                err = (a - b).abs()
                ok = ok and bool((err <= atol + rtol * b.abs()).all()) \
                    and bool(torch.isfinite(a).all())
                worst = max(worst, err.max().item())
                readings = dict(err_over_tol=f"""{((err / (atol + rtol
                                  * b.abs())).max().item()):.3f}""")
                bound_ms, bound_by = msda_bound(v, loc, attn)
                tol_text = f"{atol:g}+{rtol:g}*|ref|"
            with torch.no_grad():
                ms = time_ms(kernel, 10, INNER)
            plain_ms = time_ms(plain, 3, 1)
            phase("kernel", case=f"path_shape_{name}",
                  paths=json.dumps(sorted(NEW_SHAPES.get(key, ()))),
                  dtype=str(dtype).split(".")[-1], items=n, lq=lq,
                  levels=json.dumps(shapes, separators=(",", ":")),
                  heads=M, channels=d, max_abs_err=f"{worst:.3e}",
                  **readings, tol=json.dumps(tol_text), ms=f"{ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
                  bound_by=bound_by, ok=ok)
            check(ok, f"kernel {name} at {key} {dtype} out of tolerance: "
                      f"max abs err {worst}")
            results[key] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None)
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


# the earlier designs of the block-skipping, range-walking and sorted
# x-windowed level kernels and of the flat-walk kernel (`--old-dense-v2`,
# `--old-dense-v4`, `--old-dense-v3`, `--old-patch-v6`), and the earlier
# walk of one level (`--old-walk`): their libraries, built with the others,
# or None
OLD_V2_LIB = None
OLD_V4_LIB = None
OLD_V3_LIB = None
OLD_V6_LIB = None
OLD_WALK_LIB = None
# the earlier level designs' tile, and their shared memory for staged rows
OLD_DENSE_TQ = 256
OLD_V2_CHUNK_BYTES = 48 * 1024
OLD_V4_STAGE_BYTES = 18 * 1024
# the earlier flat walk's tile, chunk rows and columns, slots and threads
OLD_V6_GEOMETRY = (128, 8, 32, 4, 256)


def old_dense_lib(path: str, kind: str):
    """A `CudaLib` of an earlier `csrc/msda_dense_{kind}_fwd.cu` (a copy
    outside the package, for an A/B, beside the `msda_common.cuh` it was
    built with) with that design's C entry point: the first designs of the
    level kernels, a thread per (query, channel), with the tile, the
    staging budget and the threads as the last ints."""
    import ctypes
    from trackformer_tpu_torch.ops.cuda_build import CudaLib
    ptrs, ints = (5, 11) if kind == "v2" else (6, 12)
    return CudaLib(str(Path(path).resolve()), {f"msda_dense_{kind}_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p])})


def old_walk_lib(path: str):
    """A `CudaLib` of an earlier walk, `csrc/msda_dense_v4_fwd.cu` with a
    one-level C entry point of 7 pointers and 15 ints (the plan's tile,
    windows, queries a group and word last; a copy outside the package,
    beside the `msda_common.cuh` it was built with)."""
    import ctypes
    from trackformer_tpu_torch.ops.cuda_build import CudaLib
    return CudaLib(str(Path(path).resolve()), {"msda_dense_v4_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + [ctypes.c_void_p])})


def raw_old_walk(fn, v, loc, attn, plan, cw, perm=None):
    """One launch of the earlier walk through its C entry point `fn`, as
    this walk's one-level `plan` says -> (N, Lq, M, D) float32."""
    n, lq, m, p = loc.shape[:4]
    d = v.shape[-1]
    (h, w), = plan.shapes
    lv = plan.levels[0]
    out = torch.empty(n, lq, m, d, device=v.device, dtype=torch.float32)
    rc = fn(v.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            None if perm is None else perm.data_ptr(), out.data_ptr(), None,
            None, n, h, w, lq, m, p, d, int(v.dtype == torch.bfloat16), cw,
            plan.tq, lv.wr, lv.wc, lv.wps, plan.kmax, plan.word,
            torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"msda_dense_v4_fwd (earlier walk) launch failed: "
                   f"cudaError {rc}")
    return out


def old_patch_lib(path: str):
    """A `CudaLib` of an earlier `csrc/msda_patch_v6_fwd.cu` (a copy outside
    the package, beside the `msda_common.cuh` it was built with): the first
    design of the flat walk, which walks the chunk list `v6_walk` builds."""
    import ctypes
    from trackformer_tpu_torch.ops.cuda_build import CudaLib
    return CudaLib(str(Path(path).resolve()), {"msda_patch_v6_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7
        + [ctypes.c_void_p])})


def raw_walk(v, loc, attn, plan, cw, perm=None, perm_shared=None):
    """One launch of the walk through its C entry point `msda_walk_fwd`, as
    `plan` (`levels_plan`) says, with no host work beyond the call (as the
    earlier designs' entry points are timed) -> (N, Lq, M, D) float32."""
    from trackformer_tpu_torch.ops import msda_dense
    n, lq, m = loc.shape[:3]
    d = v.shape[-1]
    out = torch.empty(n, lq, m, d, device=v.device, dtype=torch.float32)
    rc = msda_dense.V4_LIB.load().msda_walk_fwd(
        v.data_ptr(), loc.data_ptr(), attn.data_ptr(),
        None if perm is None else perm.data_ptr(),
        None if perm_shared is None else perm_shared.data_ptr(),
        out.data_ptr(), None, None, None, n, lq, m, attn.shape[-1], d,
        int(v.dtype == torch.bfloat16), len(plan.shapes),
        msda_dense._c_ints(plan.table), cw, plan.tq, plan.kmax, plan.word,
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"msda_walk_fwd launch failed: cudaError {rc}")
    return out


def raw_dense(kind: str, fn, v, loc, attn, h, w, perm=None, cw=None):
    """One launch of the earlier design of kernel `kind` (v2 / v3 / v4)
    through its own C entry point `fn` (`old_dense_lib`) -> (N, Lq, M, D)
    float32."""
    n, lq, m, p = loc.shape[:4]
    d = v.shape[-1]
    out = torch.empty(n, lq, m, d, device=v.device, dtype=torch.float32)
    shape = [n, h, w, lq, m, p, d, int(v.dtype == torch.bfloat16)]
    ptrs = [v.data_ptr(), loc.data_ptr(), attn.data_ptr()]
    if kind == "v2":
        ptrs += [out.data_ptr(), None]
        tail = [OLD_DENSE_TQ, OLD_V2_CHUNK_BYTES, 256]
    else:
        ptrs += [None if perm is None else perm.data_ptr(), out.data_ptr(),
                 None]
        tail = [OLD_DENSE_TQ, cw or 0,
                OLD_V4_STAGE_BYTES if kind == "v4" else OLD_V2_CHUNK_BYTES,
                256]
    rc = fn(*ptrs, *shape, *tail, torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"msda_dense_{kind}_fwd launch failed: cudaError {rc}")
    return out


def turns_against(new, earlier: dict, want, dtype, name: str) -> dict:
    """This design (`new`) and the earlier ones given (`earlier`: field ->
    callable, or None where not given), all through their C entry points,
    timed in turns (new, each earlier one, twice) -> `entry_ms`, each
    earlier one's mean under its field ("not measured" where not given)
    and `ms_turns`; each earlier design's output held against `want`
    first."""
    given = {k: fn for k, fn in earlier.items() if fn is not None}
    fields = {k: "not measured" for k in earlier}
    if not given:
        return dict(entry_ms=f"{time_ms(new, 20, INNER):.4f}", **fields)
    atol, rtol = TOL[dtype]
    for key, fn in given.items():
        got = fn().reshape(want.shape)
        check(bool(((got - want).abs() <= atol + rtol * want.abs()).all()),
              f"{name}: the earlier design ({key}) is out of tolerance")
    turns = {"entry_ms": [], **{k: [] for k in given}}
    for _ in range(2):
        turns["entry_ms"].append(time_ms(new, 10, INNER))
        for key, fn in given.items():
            turns[key].append(time_ms(fn, 10, INNER))
    fields.update({k: f"{statistics.mean(t):.4f}" for k, t in turns.items()})
    return dict(entry_ms=fields.pop("entry_ms"), **fields,
                ms_turns=json.dumps({k: [round(x, 4) for x in t]
                                     for k, t in turns.items()}))


def dense_entry_times(kind: str, v, loc, attn, h, w, want, perm=None,
                      cw=None) -> dict:
    """Kernel `kind` through the walk's C entry point (`entry_ms`) and,
    with `--old-dense-{kind}`, the earlier design through its own
    (`old_ms`), with `--old-walk` (v2 and v4) the earlier walk through its
    own (`old_walk_ms`), timed in turns (`turns_against`)."""
    from trackformer_tpu_torch.ops import msda_dense
    n, lq, m, p = loc.shape[:4]
    plan = msda_dense.levels_plan(n, lq, m, p, v.shape[-1], ((h, w),),
                                  v.element_size(), v.data_ptr() % 16,
                                  cw or 0)

    def new():
        return raw_walk(v, loc, attn, plan, cw or 0, perm)
    old_lib = {"v2": OLD_V2_LIB, "v3": OLD_V3_LIB, "v4": OLD_V4_LIB}[kind]
    earlier = {"old_ms": None}
    if old_lib is not None:
        old_fn = getattr(old_lib.load(), f"msda_dense_{kind}_fwd")
        earlier["old_ms"] = lambda: raw_dense(kind, old_fn, v, loc, attn, h,
                                              w, perm, cw)
    if kind != "v3":
        earlier["old_walk_ms"] = None
        if OLD_WALK_LIB is not None:
            walk_fn = OLD_WALK_LIB.load().msda_dense_v4_fwd
            earlier["old_walk_ms"] = lambda: raw_old_walk(
                walk_fn, v, loc, attn, plan, cw or 0, perm)
    return turns_against(new, earlier, want, v.dtype,
                         f"msda_dense_{kind}_fwd")


def grid_sample_level(value, loc, attn, h, w):
    """The original Deformable DETR's per-level PyTorch formulation, a
    library composition (two calls, not one): `F.grid_sample` of the level
    (bilinear, zeros padding, align_corners=False), then the attention-
    weighted sum over the points. value (N, H*W, M, D), loc (N, Lq, M, P,
    2), attn (N, Lq, M, P) -> (N, Lq, M, D) float32."""
    n, _, m, d = value.shape
    lq, p = loc.shape[1], loc.shape[3]
    v = value.permute(0, 2, 3, 1).reshape(n * m, d, h, w)
    grid = (2 * loc - 1).transpose(1, 2).reshape(n * m, lq, p, 2)
    s = torch.nn.functional.grid_sample(
        v, grid.to(value.dtype), mode="bilinear", padding_mode="zeros",
        align_corners=False)                                # (N*M, D, Lq, P)
    out = (s.float() * attn.transpose(1, 2).reshape(n * m, 1, lq, p)).sum(-1)
    return out.view(n, m, d, lq).permute(0, 3, 1, 2)


def plan_fields(plan) -> dict:
    """A `walk_plan` as case-line fields."""
    return dict(tq=plan.tq, kmax=plan.kmax, word=plan.word,
                window=f"{plan.wr}x{plan.wc}", windows_per_stage=plan.wps,
                smem_bytes=plan.smem_bytes,
                grid="x".join(map(str, plan.grid)))


def kernel_phase_dense_v2(seed: int):
    """The block-skipping kernel on each level of the flagship encoder call
    (Lq = 22,323 queries per item) against `level_plain`, float32 and
    bfloat16, N = 1 and 2, with the initial offsets (scale 1) and with
    offsets six times as large, so that a tile's band spans many rows; the
    kernel's own row bands against `v2_row_band` at the tile of its plan
    (`walk_plan`, printed in every case line); times of the kernel, the
    plain version, the gather kernel and the `grid_sample` composition on
    the same level, and of the kernel through its C entry point beside the
    earlier design (`--old-dense-v2`) in turns (bfloat16, N = 2, scale
    1). At N = 2 also the differentiable wrapper
    `dense_level_pallas_v2` as the training step calls it (the level's
    slice of the whole value table): output and the three gradients
    against autograd through `level_plain`; and at the end the whole
    encoder call through route "v2" of `ms_deform_attn` (four forward and
    four backward launches) against `ms_deform_attn_plain`."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import (
        dense_level_pallas, dense_level_pallas_v2, dense_level_v2_fwd_cuda,
        v2_row_band, walk_plan)

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
                for dtype in (torch.float32, bf16):
                    v = value.to(dtype)
                    plan = walk_plan(n, lq, M, P, D, h, w, v.element_size(),
                                     v.data_ptr())
                    plain_band = v2_row_band(loc, h, plan.tq)
                    lo = plain_band[..., 0].clamp(min=0)
                    hi = plain_band[..., 1].clamp(max=h - 1)
                    rows = (hi - lo + 1).clamp(min=0).float()
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
                          **plan_fields(plan), ok=ok)
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
                        ("msda_bwd", n, lq, ((h, w),), D): 1},
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
                        comp_ms = time_ms(lambda: grid_sample_level(
                            v, loc, attn, h, w), 10, INNER)
                        ab = dense_entry_times("v2", v, loc, attn, h, w,
                                               want)
                    n_bytes = (v.numel() * 2 + loc.numel() * 4
                               + attn.numel() * 4 + got.numel() * 4)
                    bound_ms, bound_by = bound(
                        n_bytes, 2 * n * lq * M * P * 4 * D, FP32_FLOPS)
                    phase("kernel", case=f"dense_level_v2_l{level}",
                          dtype="bfloat16", items=n, ms=f"{ms:.4f}", **ab,
                          plain_ms=f"{plain_ms:.4f}",
                          gather_kernel_ms=f"{gather_ms:.4f}",
                          grid_sample_composition_ms=f"{comp_ms:.4f}",
                          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
                    results[level] = dict(
                        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        library_ms=None, gather_kernel_ms=gather_ms,
                        grid_sample_composition_ms=comp_ms)

    # the walk's own edges at the full width: tiles whose band holds rows
    # with no sample of a head (each tile's queries split between the top
    # and the bottom of the level), and supports that straddle the window
    # borders (rows on and half a cell beside multiples of 6), in float32
    # and bfloat16, with the bands against `v2_row_band`
    h, w = LEVELS[0]
    lq = 4800
    value = torch.randn(1, h * w, M, D, device="cuda", generator=gen)
    attn = torch.rand(1, lq, M, P, device="cuda", generator=gen)
    far = torch.tensor([0.08, 0.92], device="cuda")[
        torch.arange(lq, device="cuda") % 2]
    skipped = (far[None, :, None, None, None] + 0.02 * torch.randn(
        1, lq, M, P, 2, device="cuda", generator=gen)).contiguous()
    by = 6 * torch.randint(1, h // 6 + 1, (1, lq, M, P), device="cuda",
                           generator=gen)
    off = torch.tensor([-0.5, -0.25, 0.0, 0.25], device="cuda")
    y = (by + off[torch.randint(0, 4, (1, lq, M, P), device="cuda",
                                generator=gen)]).clamp(max=h - 1)
    x = torch.rand(1, lq, M, P, device="cuda", generator=gen) * w - 0.5
    borders = torch.stack([(x + 0.5) / w, (y + 0.5) / h], -1).contiguous()
    for case, loc in (("dense_level_v2_skipped_windows", skipped),
                      ("dense_level_v2_borders", borders)):
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            plan = walk_plan(1, lq, M, P, D, h, w, v.element_size(),
                             v.data_ptr())
            want_band = v2_row_band(loc, h, plan.tq)
            with torch.no_grad():
                got, band = dense_level_v2_fwd_cuda(v, loc, attn, h, w,
                                                    return_band=True)
                torch.cuda.synchronize()
                want = msda.level_plain(v, loc, attn, h, w)
            band_ok = (bool((band[..., 0] == want_band[..., 0].clamp(
                min=0)).all()) and bool((band[..., 1] == want_band[
                    ..., 1].clamp(max=h - 1)).all()))
            held_against_plain(case, dtype, got, want, level=f"{h}x{w}",
                               lq=lq, band_ok=band_ok, **plan_fields(plan))
            check(band_ok, f"kernel {case}: row bands differ from "
                           "v2_row_band")

    # the other staging words (`ODD_LEVELS`), three heads, ragged tiles
    h, w = ODD_LEVELS[0]
    for d in (5, 6):
        value, loc, attn = odd_shape_inputs(gen, d, ODD_LEVELS[:1], 70)
        loc, attn = loc[:, :, :, 0].contiguous(), attn[:, :, :, 0].contiguous()
        want_band = v2_row_band(loc, h, ODD_TQ)
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            got, band = dense_level_v2_fwd_cuda(v, loc, attn, h, w,
                                                tq=ODD_TQ, return_band=True)
            band_ok = (bool((band[..., 0] == want_band[..., 0].clamp(
                min=0)).all()) and bool((band[..., 1] == want_band[
                    ..., 1].clamp(max=h - 1)).all()))
            held_against_plain("dense_level_v2_odd_shape", dtype, got,
                               msda.level_plain(v, loc, attn, h, w), d=d,
                               band_ok=band_ok)
            check(band_ok, "dense_level_v2 odd shape: row bands")

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
        dense_level_pallas, dense_level_pallas_v4, dense_level_pallas_v4p,
        dense_level_v2_fwd_cuda, dense_level_v4_fwd_cuda, spatial_sort_perm,
        v4_ranges, walk_plan)

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    bf16 = torch.bfloat16
    cw = msda.PALLAS_V4_CW
    s_enc = sum(h * w for h, w in LEVELS)
    results = {}

    def held(tag, value, loc, attn, h, w, perm, chunk, **fields):
        """Both dtypes against the plain level, the kernel's walk bounds
        against `v4_ranges` at the tile of its plan (`walk_plan`) -> the
        bfloat16 max abs error."""
        n, lq, m, p = loc.shape[:4]
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            plan = walk_plan(n, lq, m, p, v.shape[-1], h, w,
                             v.element_size(), v.data_ptr(), chunk or 0)
            want_r = v4_ranges(loc, h, w, plan.tq, chunk, perm)
            cells = ((want_r[..., 1] - want_r[..., 0] + 1).clamp(min=0)
                     * (want_r[..., 3] - want_r[..., 2] + 1)).float()
            with torch.no_grad():
                got, ranges = dense_level_v4_fwd_cuda(
                    v, loc, attn, h, w, perm=perm, cw=chunk,
                    return_ranges=True)
                torch.cuda.synchronize()
                want = msda.level_plain(v, loc, attn, h, w)
            ranges_ok = bool((ranges.long() == want_r).all())
            err = held_against_plain(
                tag, dtype, got, want, level=f"{h}x{w}", items=n, lq=lq,
                **fields,
                walk="sorted, chunks of %d" % chunk if chunk else
                "raster, full width",
                mean_range_cells=f"{cells.mean().item():.0f}",
                range_skips=f"{1 - cells.mean().item() / (h * w):.4f}",
                ranges_ok=ranges_ok, **plan_fields(plan))
            check(ranges_ok, f"kernel {tag}: walk bounds differ from "
                             "v4_ranges")
        return err

    def timed(tag, v, loc, attn, h, w, perm, err):
        with torch.no_grad():
            want = msda.level_plain(v, loc, attn, h, w)
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
            comp_ms = time_ms(lambda: grid_sample_level(v, loc, attn, h, w),
                              10, INNER)
            sort_ms = time_ms(lambda: spatial_sort_perm(loc, h, w), 10, INNER)
            ab = dense_entry_times("v4", v, loc, attn, h, w, want, perm, cw)
            ab_rows = dense_entry_times("v4", v, loc, attn, h, w, want)
        bound_ms, bound_by = level_bound(v, loc, attn, h, w, perm.numel() * 8)
        phase("kernel", case=tag, dtype="bfloat16", items=loc.shape[0],
              lq=loc.shape[1], ms=f"{ms:.4f}", **ab,
              unsorted_full_width_ms=f"{rows_ms:.4f}",
              unsorted_full_width_entry_ms=ab_rows["entry_ms"],
              unsorted_full_width_old_ms=ab_rows["old_ms"],
              unsorted_full_width_old_walk_ms=ab_rows["old_walk_ms"],
              plain_ms=f"{plain_ms:.4f}", gather_kernel_ms=f"{gather_ms:.4f}",
              block_skipping_kernel_ms=f"{v2_ms:.4f}",
              grid_sample_composition_ms=f"{comp_ms:.4f}",
              spatial_sort_ms=f"{sort_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
              bound_by=bound_by)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    gather_kernel_ms=gather_ms, block_skipping_kernel_ms=v2_ms,
                    grid_sample_composition_ms=comp_ms,
                    unsorted_full_width_ms=rows_ms)

    # the composition that the times are set beside computes this function
    h, w = LEVELS[1]
    value, loc, attn = encoder_level_inputs(1, 1, 6.0, gen)
    with torch.no_grad():
        held_against_plain("grid_sample_composition", torch.float32,
                           grid_sample_level(value, loc, attn, h, w),
                           msda.level_plain(value, loc, attn, h, w),
                           level=f"{h}x{w}")

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
                            ("msda_bwd", n, s_enc, ((h, w),), D): 1},
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
    # more than four points a query: 24 corners, sorted in place (the
    # sorting network takes at most 16)
    value, loc, attn = odd_shape_inputs(gen, 6, ODD_LEVELS[:1], 70)
    _, loc2, attn2 = odd_shape_inputs(gen, 6, ODD_LEVELS[:1], 70)
    loc = torch.cat([loc, loc2], 4)[:, :, :, 0].contiguous()
    attn = torch.cat([attn, attn2], 4)[:, :, :, 0].contiguous()
    perm = spatial_sort_perm(loc, h, w)
    for dtype in (torch.float32, bf16):
        v = value.to(dtype)
        got = dense_level_v4_fwd_cuda(v, loc, attn, h, w, perm=perm, cw=8,
                                      tq=ODD_TQ)
        held_against_plain("dense_level_v4_many_points", dtype, got,
                           msda.level_plain(v, loc, attn, h, w),
                           points=loc.shape[3])

    # head rows wider than a warp, two passes of a lane group over each
    # row: float32 rows of 160 channels (40 words of 16 bytes), and D = 36
    # bfloat16 rows at a value pointer one element off its alignment (36
    # words of 2 bytes); sorted in chunks and unsorted at the full width
    h, w = LEVELS[1]
    _, loc, attn = encoder_level_inputs(1, 1, 6.0, gen)
    loc, attn = loc[:, :4096].contiguous(), attn[:, :4096].contiguous()
    perm = spatial_sort_perm(loc, h, w)
    for what, d, dtype in (("float32 rows of 160 channels", 160,
                            torch.float32),
                           ("bfloat16 rows one element off", D, bf16)):
        value = torch.randn(1, h * w, M, d, device="cuda", generator=gen)
        if dtype == bf16:
            buf = torch.empty(value.numel() + 1, dtype=bf16, device="cuda")
            buf[1:] = value.flatten().to(bf16)
            v = buf[1:].view(value.shape)
        else:
            v = value
        for order, chunk in ((perm, cw), (None, None)):
            plan = walk_plan(1, loc.shape[1], M, P, d, h, w,
                             v.element_size(), v.data_ptr(), chunk or 0)
            check(plan.passes == 2, f"{what}: plan {plan}")
            want_r = v4_ranges(loc, h, w, plan.tq, chunk, order)
            with torch.no_grad():
                got, ranges = dense_level_v4_fwd_cuda(
                    v, loc, attn, h, w, perm=order, cw=chunk,
                    return_ranges=True)
                torch.cuda.synchronize()
                want = msda.level_plain(v, loc, attn, h, w)
            ranges_ok = bool((ranges.long() == want_r).all())
            held_against_plain(
                "dense_level_v4_wide_rows", dtype, got, want,
                rows=json.dumps(what), d=d,
                value_ptr_mod_16=v.data_ptr() % 16, passes=plan.passes,
                walk="sorted, chunks of %d" % chunk if chunk else
                "raster, full width", ranges_ok=ranges_ok,
                **plan_fields(plan))
            check(ranges_ok, f"dense_level_v4 {what}: walk bounds")

    # the walk's own edges on the finest level: a tile whose range holds
    # windows with no sample (the queries of each tile split between two
    # far corners of the level, in query order), and supports that
    # straddle chunk and window borders (coordinates on and half a cell
    # beside multiples of 32 columns and 6 rows: the chunks of 64, the
    # dense windows of 32 columns and the sparse windows' 8 x 2 all border
    # there), with sparse (96 queries) and dense (4,800) plans
    h, w = LEVELS[0]
    for lq in (96, 4800):
        value = torch.randn(1, h * w, M, D, device="cuda", generator=gen)
        attn = torch.rand(1, lq, M, P, device="cuda", generator=gen)
        jitter = 0.02 * torch.randn(1, lq, M, P, 2, device="cuda",
                                    generator=gen)
        far = torch.tensor([0.08, 0.92], device="cuda")[
            torch.arange(lq, device="cuda") % 2]
        loc = (far[None, :, None, None, None] + jitter).contiguous()
        held("dense_level_v4_skipped_windows", value, loc, attn, h, w, None,
             cw, sample="two far corners a tile")
        bx = 32 * torch.randint(1, w // 32 + 1, (1, lq, M, P), device="cuda",
                                generator=gen)
        by = 6 * torch.randint(1, h // 6 + 1, (1, lq, M, P), device="cuda",
                               generator=gen)
        off = torch.tensor([-0.5, -0.25, 0.0, 0.25], device="cuda")
        pick = torch.randint(0, 4, (2, 1, lq, M, P), device="cuda",
                             generator=gen)
        x = (bx + off[pick[0]]).clamp(max=w - 1)
        y = (by + off[pick[1]]).clamp(max=h - 1)
        loc = torch.stack([(x + 0.5) / w, (y + 0.5) / h], -1).contiguous()
        held("dense_level_v4_borders", value, loc, attn, h, w,
             spatial_sort_perm(loc, h, w), cw, sample="on window borders")
        held("dense_level_v4_borders", value, loc, attn, h, w, None, None,
             sample="on window borders")

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
    """The sorted, x-windowed kernel, the walk in a spatial sort and
    64-column chunks: the public op on each level of the captured encoder
    call (its path), its windows against `v3_windows` at the tile of its
    plan; the same N = 2 with offsets six times as large, where tiles do
    not fit, and with every 16th query's samples pushed across the border;
    and with a window of one column, which no tile fits, so that every tile
    takes the full width. -> results by level."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import (
        V3_CW, dense_level_pallas, dense_level_pallas_v3,
        dense_level_v2_fwd_cuda, dense_level_v3_fwd_cuda, spatial_sort_perm,
        v3_windows, walk_plan)

    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    bf16 = torch.bfloat16
    value_all, loc_all, attn_all = captured
    s_enc = loc_all.shape[1]
    results, fit_share = {}, []

    def windows_at_plan(v, loc, h, w, perm, cw):
        """`v3_windows` at the tile of the walk's plan, and the plan."""
        n, lq, m, p = loc.shape[:4]
        plan = walk_plan(n, lq, m, p, v.shape[-1], h, w, v.element_size(),
                         v.data_ptr(), cw)
        return v3_windows(loc, h, w, perm, plan.tq, cw), plan

    for level, (h, w) in enumerate(LEVELS):
        start = sum(a * b for a, b in LEVELS[:level])
        cases = [("captured call", value_all[:, start:start + h * w].float(),
                  loc_all[:, :, :, level].contiguous(),
                  attn_all[:, :, :, level].contiguous())]
        cases.append(("offsets x6, N=2",
                      *encoder_level_inputs(level, TRAIN_BATCH, 6.0, gen)))
        value, loc, attn = encoder_level_inputs(level, TRAIN_BATCH, 1.0, gen)
        loc[:, ::16] = loc[:, ::16] * 1.2 - 0.1
        cases.append(("pushed across the border, N=2", value, loc, attn))
        for what, value, loc, attn in cases:
            perm = spatial_sort_perm(loc, h, w)
            for dtype in (torch.float32, bf16):
                v = value.to(dtype).contiguous()
                want_w, plan = windows_at_plan(v, loc, h, w, perm, V3_CW)
                none_w, _ = windows_at_plan(v, loc, h, w, perm, 1)
                fits = want_w[..., 3].float().mean().item()
                fit_share.append(fits)
                with torch.no_grad():
                    got, windows = dense_level_v3_fwd_cuda(
                        v, loc, attn, h, w, return_windows=True)
                    full, none_fit = dense_level_v3_fwd_cuda(
                        v, loc, attn, h, w, cw=1, return_windows=True)
                    torch.cuda.synchronize()
                    want = msda.level_plain(v, loc, attn, h, w)
                windows_ok = bool((windows.long() == want_w).all())
                none_ok = bool((none_fit.long() == none_w).all())
                err = held_against_plain(
                    f"dense_level_v3_l{level}", dtype, got, want,
                    level=f"{h}x{w}", inputs=json.dumps(what),
                    items=loc.shape[0], tiles_that_fit=f"{fits:.4f}",
                    windows_ok=windows_ok, **plan_fields(plan))
                held_against_plain(
                    f"dense_level_v3_l{level}", dtype, full, want,
                    level=f"{h}x{w}", inputs=json.dumps(what),
                    branch="cw=1: every tile on the full width",
                    tiles_that_fit=int(none_fit[..., 3].sum().item()),
                    windows_ok=none_ok)
                check(int(none_fit[..., 3].sum().item()) == 0,
                      f"dense_level_v3 level {level}: a tile fits one column")
                check(windows_ok and none_ok,
                      f"kernel dense_level_v3 level {level}: windows differ "
                      "from v3_windows")
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
                want = msda.level_plain(v, loc, attn, h, w)
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
                sort_ms = time_ms(lambda: spatial_sort_perm(loc, h, w), 10,
                                  INNER)
                ab = dense_entry_times("v3", v, loc, attn, h, w, want, perm,
                                       V3_CW)
            bound_ms, bound_by = level_bound(v, loc, attn, h, w)
            phase("kernel", case=f"dense_level_v3_l{level}",
                  dtype="bfloat16", items=1, lq=s_enc, ms=f"{with_sort_ms:.4f}",
                  kernel_alone_ms=f"{ms:.4f}", **ab,
                  spatial_sort_ms=f"{sort_ms:.4f}",
                  every_tile_full_width_ms=f"{full_ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}",
                  gather_kernel_ms=f"{gather_ms:.4f}",
                  block_skipping_kernel_ms=f"{v2_ms:.4f}",
                  bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
            results[level] = dict(
                max_abs_err=err, ms=with_sort_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                kernel_alone_ms=ms, entry_ms=ab["entry_ms"],
                old_ms=ab["old_ms"], gather_kernel_ms=gather_ms,
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


# the earlier design of the precomputed-rows gather (`--old-gather-rows`):
# its library, built with the others, or None
OLD_ROWS_LIB = None


def old_rows_lib(path: str):
    """A `CudaLib` of an earlier `csrc/msda_gather_rows_fwd.cu` (a copy
    outside the package, beside the `msda_common.cuh` it was built with)
    with the first design's C entry point: a warp per (item * head,
    query), lanes over channels, the head-major float32 table, warps per
    block last."""
    import ctypes
    from trackformer_tpu_torch.ops.cuda_build import CudaLib
    return CudaLib(str(Path(path).resolve()), {"msda_gather_rows_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])})


def raw_gather_rows(idx, w, v, plan, out):
    """One launch of the gather through its C entry point as `plan` says,
    into `out`, with no host work beyond the call -> out."""
    from trackformer_tpu_torch.ops import msda_pallas
    n, s, m, d = v.shape
    lq, k = idx.shape[1:]
    rc = msda_pallas.LIB.load().msda_gather_rows_fwd(
        idx.data_ptr(), w.data_ptr(), v.data_ptr(), out.data_ptr(), n, s, m,
        lq, k, d, int(v.dtype == torch.bfloat16), plan.word, plan.qstep,
        plan.chunk, plan.passes, plan.warps, plan.smem_bytes, plan.grid[0],
        torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"msda_gather_rows_fwd launch failed: cudaError {rc}")
    return out


def graph_ms(fn, calls: int = 20) -> float:
    """Median device milliseconds of one call of `fn`, replayed from a CUDA
    graph of `calls` calls: no host time between launches."""
    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def corners_held(tag: str, shapes, loc, attn, **fields) -> None:
    """The corner build against `corner_operands_plain` on the card, bit
    for bit (indices, and weights as bits); prints the reading, fails the
    run if a bit differs."""
    from trackformer_tpu_torch.ops.msda_pallas import (
        corner_operands_cuda, corner_operands_plain)
    idx, w = corner_operands_cuda(shapes, loc, attn)
    torch.cuda.synchronize()
    want_idx, want_w = corner_operands_plain(shapes, loc, attn)
    idx_diff = int((idx != want_idx).sum())
    w_diff = int((w.view(torch.int32) != want_w.view(torch.int32)).sum())
    phase("kernel", case=tag, locations=str(loc.dtype).split(".")[-1],
          weights=str(attn.dtype).split(".")[-1], corners=idx.numel(),
          indices_differing=idx_diff, weight_bits_differing=w_diff,
          tol="bit for bit", ok=idx_diff == 0 and w_diff == 0)
    check(idx_diff == 0 and w_diff == 0,
          f"{tag} {fields}: {idx_diff} indices and {w_diff} weights differ "
          f"from corner_operands_plain")


def kernel_phase_gather_rows(seed: int, captured):
    """The precomputed-rows gather, two kernels: the corner build bit for
    bit against `corner_operands_plain` with float32 and bfloat16 locations
    and weights; the gather (the value read in place) against
    `gather_rows_plain`, float32 and bfloat16 values, with every corner of a
    query on one row (`ms_one_cell`: every row read an L1 hit, three rows a
    load instruction) and every corner on one row of the call (`ms_one_row`:
    one row a load instruction); the op `ms_deform_attn_pallas` against
    `ms_deform_attn_plain` (bfloat16 locations: against the plain versions
    of the two kernels), with its launches; at the captured encoder call
    (K = 64) and at the decoder call's shape (K = 128, 650 scattered
    queries). Times: the gather through its wrapper and its C entry point,
    as device time (`graph_ms`), with `--old-gather-rows` the earlier design
    through its own C entry point in turns (its float32 head-major table
    built outside the timing); the corner build; the whole op; the plain
    gather; the MSDA forward kernel on the same call; the one library call
    that computes the same function, also as device time
    (`torch.nn.functional.embedding_bag` with per-sample weights over the
    float32 value read in place as a table of N * S * M rows; used nowhere
    in the port). Then the odd shape (D = 5, K = 24) and a value pointer one
    element off its alignment. -> results by ("gather" / "corners",
    "encoder" / "decoder")."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_pallas import (
        corner_operands_cuda, corner_operands_plain, gather_plan,
        gather_rows_cuda, gather_rows_plain, ms_deform_attn_pallas)

    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    bf16, f32 = torch.bfloat16, torch.float32
    dec_levels = LEVELS * 2
    cases = [("encoder", LEVELS, *captured),
             ("decoder", dec_levels,
              *msda_inputs(dec_levels, DEC_QUERIES, False, gen, 1))]
    results = {}
    for name, shapes, value, loc, attn in cases:
        lq = loc.shape[1]
        for ld in (f32, bf16):
            for ad in (f32, bf16):
                corners_held(f"msda_corners_{name}", shapes, loc.to(ld),
                             attn.to(ad))
        with torch.no_grad():
            for dtype in (f32, bf16):
                v = value.to(dtype)
                got = ms_deform_attn_pallas(v, shapes, loc, attn)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_plain(v, shapes, loc, attn)
                check(got.dtype == dtype and got.shape == (1, lq, M * D),
                      f"ms_deform_attn_pallas {name}: output")
                held_against_plain(f"ms_deform_attn_pallas_{name}", dtype,
                                   got.float(), want.flatten(2), items=1,
                                   lq=lq, levels=len(shapes))
                # bfloat16 locations and weights: the JAX wrapper's corners
                loc_b, attn_b = loc.to(bf16), attn.to(bf16)
                held_against_plain(
                    f"ms_deform_attn_pallas_{name}", dtype,
                    ms_deform_attn_pallas(v, shapes, loc_b, attn_b).float(),
                    gather_rows_plain(*corner_operands_plain(
                        shapes, loc_b, attn_b), v).flatten(2),
                    locations="bfloat16", weights="bfloat16")
            idx, w = corner_operands_cuda(shapes, loc, attn)
            one_cell = idx[..., :1].expand_as(idx).contiguous()
            one_row = torch.zeros_like(idx)
            gather_err = {}
            for dtype in (f32, bf16):
                v = value.to(dtype).contiguous()
                plan = gather_plan(1, lq, M, idx.shape[2], D,
                                   v.element_size(), v.data_ptr())
                for what, ix in (("corners", idx), ("one_cell", one_cell),
                                 ("one_row", one_row)):
                    got = gather_rows_cuda(ix, w, v, shapes)
                    torch.cuda.synchronize()
                    err = held_against_plain(
                        f"msda_gather_rows_{name}", dtype, got,
                        gather_rows_plain(ix, w, v), indices=what,
                        k=idx.shape[2], plan=json.dumps(list(plan[:7])))
                    gather_err.setdefault(dtype, err)
        v = value.to(bf16).contiguous()
        reset_launch_counts()
        with torch.no_grad():
            ms_deform_attn_pallas(v, shapes, loc, attn)     # the path
        counts = {k: c for k, c in msda.launch_counts().items() if c}
        record_path()
        check(counts == {"ms_deform_attn_pallas": 1,
                         "ms_deform_attn_pallas_corners": 1},
              f"ms_deform_attn_pallas {name} launched {counts}")
        with torch.no_grad():
            times = {}
            for dtype in (bf16, f32):
                vd = value.to(dtype).contiguous()
                plan = gather_plan(1, lq, M, idx.shape[2], D,
                                   vd.element_size(), vd.data_ptr())
                out = torch.empty(1, lq, M, D, dtype=dtype, device="cuda")
                sfx = "" if dtype == bf16 else "_f32"
                times["ms" + sfx] = time_ms(lambda: gather_rows_cuda(
                    idx, w, vd, shapes), 20, INNER)
                times["device_ms" + sfx] = graph_ms(
                    lambda: raw_gather_rows(idx, w, vd, plan, out))
                for what, ix in (("one_cell", one_cell),
                                 ("one_row", one_row)):
                    times[f"device_ms_{what}{sfx}"] = graph_ms(
                        lambda: raw_gather_rows(ix, w, vd, plan, out))
                times["whole_op_ms" + sfx] = time_ms(
                    lambda: ms_deform_attn_pallas(vd, shapes, loc, attn), 20,
                    INNER)
            # the earlier design in turns, on its float32 head-major table
            b = M
            want_hm = gather_rows_plain(idx, w, v).permute(0, 2, 1, 3) \
                .reshape(b, lq, D)
            table = v.float().permute(0, 2, 1, 3).reshape(b, -1, D) \
                .contiguous()
            plan = gather_plan(1, lq, M, idx.shape[2], D, 2, v.data_ptr())
            out = torch.empty(1, lq, M, D, dtype=bf16, device="cuda")
            old = None
            if OLD_ROWS_LIB is not None:
                old_fn = OLD_ROWS_LIB.load().msda_gather_rows_fwd
                old_out = torch.empty(b, lq, D, device="cuda")

                def old():
                    rc = old_fn(idx.data_ptr(), w.data_ptr(),
                                table.data_ptr(), old_out.data_ptr(), b,
                                table.shape[1], lq, idx.shape[2], D, 8,
                                torch.cuda.current_stream().cuda_stream)
                    check(rc == 0, f"msda_gather_rows_fwd (earlier design) "
                                   f"launch failed: cudaError {rc}")
                    return old_out
            ab = turns_against(
                lambda: raw_gather_rows(idx, w, v, plan, out),
                {"old_ms": old}, want_hm, f32, "msda_gather_rows_fwd")
            corner_ms = time_ms(lambda: corner_operands_cuda(
                shapes, loc, attn), 20, INNER)
            corner_device_ms = graph_ms(lambda: corner_operands_cuda(
                shapes, loc, attn))
            corner_plain_ms = time_ms(lambda: corner_operands_plain(
                shapes, loc, attn), 5, INNER)
            plain_ms = time_ms(lambda: gather_rows_plain(idx, w, v), 5,
                               INNER)
            # the MSDA forward kernel on the same call, for scale
            fwd_ms = time_ms(lambda: msda.ms_deform_attn(v, shapes, loc,
                                                         attn), 20, INNER)
            # the library call: the float32 value in place as one table of
            # N * S * M rows, one bag of K rows per (item * head, query)
            flat_table = value.float().reshape(-1, D)
            heads = torch.arange(M, device="cuda", dtype=torch.int32)
            bags = (idx * M + heads[:, None, None]).reshape(M * lq, -1)
            bag_w = w.reshape(M * lq, -1)

            def library():
                return torch.nn.functional.embedding_bag(
                    bags, flat_table, per_sample_weights=bag_w, mode="sum")

            lib_out = library().reshape(M, lq, D)
            kern_f32 = gather_rows_cuda(idx, w, value.float().contiguous(),
                                        shapes).permute(0, 2, 1, 3)[0]
            lib_err = (kern_f32 - lib_out).abs().max().item()
            check(bool(((kern_f32 - lib_out).abs()
                        <= 1e-5 + 1e-5 * lib_out.abs()).all()),
                  f"gather_rows {name}: kernel against embedding_bag: "
                  f"{lib_err}")
            library_ms = time_ms(library, 20, INNER)
            library_device_ms = graph_ms(library)
        rows = touched_value_rows(loc, shapes)
        k = idx.shape[2]
        flops = 2 * idx.numel() * D
        bound_ms, bound_by = bound(idx.numel() * 8 + rows * D * 2
                                   + lq * M * D * 2, flops, FP32_FLOPS)
        bound_f32_ms, _ = bound(idx.numel() * 8 + rows * D * 4
                                + lq * M * D * 4, flops, FP32_FLOPS)
        corner_bound_ms, corner_bound_by = bound(
            loc.numel() * 4 + attn.numel() * 4 + idx.numel() * 8,
            idx.numel() * 12, FP32_FLOPS)
        fmt = {key: f"{t:.4f}" for key, t in times.items()}
        phase("kernel", case=f"msda_gather_rows_{name}", dtype="bfloat16",
              items=1, lq=lq, k=k, table="the value in place",
              plan=json.dumps(list(plan[:7])), **fmt, **ab,
              corner_build_ms=f"{corner_ms:.4f}",
              corner_build_device_ms=f"{corner_device_ms:.4f}",
              corner_build_plain_ms=f"{corner_plain_ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
              library_device_ms=f"{library_device_ms:.4f}",
              library_max_abs_diff=f"{lib_err:.3e}",
              msda_fwd_same_call_ms=f"{fwd_ms:.4f}",
              bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
              bound_float32_table_ms=f"{bound_f32_ms:.4f}",
              corner_build_bound_ms=f"{corner_bound_ms:.4f}")
        results[("gather", name)] = dict(
            max_abs_err=gather_err[bf16], ms=times["ms"], plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            **{key: t for key, t in times.items() if key != "ms"},
            entry_ms=ab["entry_ms"], old_ms=ab["old_ms"],
            bound_float32_table_ms=bound_f32_ms,
            library_device_ms=library_device_ms,
            msda_fwd_same_call_ms=fwd_ms)
        results[("corners", name)] = dict(
            max_abs_err=0.0, ms=corner_ms, plain_ms=corner_plain_ms,
            bound_ms=corner_bound_ms, bound_by=corner_bound_by,
            library_ms=None, device_ms=corner_device_ms)
        del idx, w, one_cell, one_row, table, flat_table, bags, bag_w
    # K = 24 corners, D = 5 channels (2- and 4-byte words), and a value one
    # element off its alignment at the decoder call's shape (2- and 4-byte
    # words, a row of 36 words in two passes)
    value, loc, attn = odd_shape_inputs(gen, 5, ODD_LEVELS, 70)
    corners_held("msda_corners_odd_shape", ODD_LEVELS, loc.to(bf16),
                 attn.to(bf16))
    value_d, loc_d, attn_d = msda_inputs(dec_levels, DEC_QUERIES, False, gen,
                                         1)
    for dtype in (f32, bf16):
        v = value.to(dtype)
        held_against_plain(
            "ms_deform_attn_pallas_odd_shape", dtype,
            ms_deform_attn_pallas(v, ODD_LEVELS, loc, attn).float(),
            msda.ms_deform_attn_plain(v, ODD_LEVELS, loc, attn).flatten(2),
            d=5, k=24)
        store = torch.empty(value_d.numel() + 1, dtype=dtype, device="cuda")
        v = store[1:].view(value_d.shape)
        v.copy_(value_d)
        plan = gather_plan(1, DEC_QUERIES, M, 128, D, v.element_size(),
                           v.data_ptr())
        held_against_plain(
            "ms_deform_attn_pallas_unaligned", dtype,
            ms_deform_attn_pallas(v, dec_levels, loc_d, attn_d).float(),
            msda.ms_deform_attn_plain(v, dec_levels, loc_d, attn_d)
            .flatten(2), offset_bytes=v.element_size(),
            plan=json.dumps(list(plan[:7])))
    return results


def old_patch_v6(lib, value, loc, attn):
    """The earlier flat walk (`--old-patch-v6`) through its C entry point:
    `v6_walk` at its geometry, then its kernel -> ((N, S, M, D) float32,
    the kernel alone as a callable on the same walk)."""
    import ctypes
    from trackformer_tpu_torch.ops.msda_patch import (_snake_perm_on,
                                                      v6_max_chunks, v6_walk)
    tq, ph, pw, nslots, threads = OLD_V6_GEOMETRY
    n, s, m, d = value.shape
    l, p = loc.shape[3], loc.shape[4]
    perm = _snake_perm_on(LEVELS, value.device)
    maxc = v6_max_chunks(LEVELS, ph, pw)
    hw = (ctypes.c_int * (2 * l))(*[v for pair in LEVELS for v in pair])

    def kernel(walk):
        codes, totals = walk
        out = torch.empty(n, s, m, d, dtype=torch.float32,
                          device=value.device)
        rc = lib.msda_patch_v6_fwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            perm.data_ptr(), codes.data_ptr(), totals.contiguous().data_ptr(),
            out.data_ptr(), n, s, m, l, p, d, hw,
            int(value.dtype == torch.bfloat16), tq, ph, pw, nslots, maxc,
            threads, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"msda_patch_v6_fwd (earlier design) launch failed: "
                       f"cudaError {rc}")
        return out

    walk = v6_walk(LEVELS, loc, tq, ph, pw)
    return (lambda: kernel(v6_walk(LEVELS, loc, tq, ph, pw))), \
        (lambda: kernel(walk))


def kernel_phase_patch_v6(seed: int, captured):
    """The flat chunk walk, on the card the walk over all levels in snake
    order: `msda_patch_v6` on the captured encoder call (its path) and on
    N = 2 items with every 16th query's samples pushed across the border,
    float32 and bfloat16, against `ms_deform_attn_plain`; the wrapper's
    gradients; times of the op, of the walk over each level alone (the
    split by level), of the plain version and of the gather kernel on the
    same call, and with `--old-patch-v6` of the earlier design (its
    `v6_walk` and kernel, and the kernel alone) in turns with this one,
    both through their C entry points. -> result."""
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.msda_dense import levels_plan
    from trackformer_tpu_torch.ops.msda_patch import (
        V6_CW, _snake_perm_on, msda_patch, msda_patch_v6,
        msda_patch_v6_fwd_cuda)

    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    bf16 = torch.bfloat16
    s_enc = sum(h * w for h, w in LEVELS)
    pushed = msda_inputs(LEVELS, s_enc, True, gen, TRAIN_BATCH)
    pushed[1][:, ::16] = pushed[1][:, ::16] * 1.2 - 0.1
    errs = {}
    for what, (value, loc, attn) in (("captured call", captured),
                                     ("pushed across the border, N=2",
                                      pushed)):
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            plan = levels_plan(loc.shape[0], s_enc, M, P, D, LEVELS,
                               v.element_size(), v.data_ptr() % 16, V6_CW)
            with torch.no_grad():
                got = msda_patch_v6(v, LEVELS, loc, attn)
                torch.cuda.synchronize()
                want = msda.ms_deform_attn_plain(v, LEVELS, loc, attn)
            errs[(what, dtype)] = held_against_plain(
                "msda_patch_v6", dtype, got, want, inputs=json.dumps(what),
                items=loc.shape[0], lq=s_enc, tile=plan.tq,
                windows=json.dumps([f"{lv.wr}x{lv.wc}" for lv in plan.levels]),
                windows_per_stage=json.dumps([lv.wps for lv in plan.levels]),
                smem_bytes=plan.smem_bytes,
                grid="x".join(map(str, plan.grid)))
    s_odd = sum(h * w for h, w in ODD_LEVELS)
    for d in (5, 6):                # the other staging words, ragged tiles
        value, loc, attn = odd_shape_inputs(gen, d, ODD_LEVELS, s_odd)
        for dtype in (torch.float32, bf16):
            v = value.to(dtype)
            held_against_plain(
                "msda_patch_v6_odd_shape", dtype,
                msda_patch_v6_fwd_cuda(v, ODD_LEVELS, loc, attn, tq=ODD_TQ),
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
    plan = levels_plan(1, s_enc, M, P, D, LEVELS, 2, v.data_ptr() % 16,
                       V6_CW)
    perm = _snake_perm_on(LEVELS, v.device)
    with torch.no_grad():
        want = msda.ms_deform_attn_plain(v, LEVELS, loc, attn)
        ms = time_ms(lambda: msda_patch_v6(v, LEVELS, loc, attn), 20, INNER)
        plain_ms = time_ms(lambda: msda.ms_deform_attn_plain(
            v, LEVELS, loc, attn), 5, INNER)
        gather_ms = time_ms(lambda: msda_patch(v, LEVELS, loc, attn), 20,
                            INNER)
        # the split by level: the same walk over one level at a time, the
        # tiles and windows of the all-levels plan
        level_ms = []
        for lvl, (h, w) in enumerate(LEVELS):
            start = plan.starts[lvl]
            args = (v[:, start:start + h * w].contiguous(),
                    loc[:, :, :, lvl:lvl + 1].contiguous(),
                    attn[:, :, :, lvl:lvl + 1].contiguous())
            one = levels_plan(1, s_enc, M, P, D, ((h, w),), 2,
                              args[0].data_ptr() % 16, V6_CW, plan.tq)
            check(one.levels[0] == plan.levels[lvl],
                  f"msda_patch_v6 level {lvl}: another plan alone")
            level_ms.append(time_ms(lambda: raw_walk(
                *args, one, V6_CW, perm_shared=perm), 20, INNER))

        def new():
            return raw_walk(v, loc, attn, plan, V6_CW, perm_shared=perm)
        old_op = old_kernel = None
        if OLD_V6_LIB is not None:
            old_op, old_kernel = old_patch_v6(
                OLD_V6_LIB.load(), v, loc, attn)
        ab = turns_against(new, {"old_ms": old_op,
                                 "old_kernel_alone_ms": old_kernel}, want,
                           bf16, "msda_patch_v6_fwd")
    rows = touched_value_rows(loc, LEVELS)
    n_bytes = (rows * D * 2 + loc.numel() * 4 + attn.numel() * 4
               + s_enc * M * D * 4 + s_enc * 4)
    bound_ms, bound_by = bound(
        n_bytes, s_enc * M * len(LEVELS) * P * D * 10, FP32_FLOPS)
    phase("kernel", case="msda_patch_v6", dtype="bfloat16", items=1,
          lq=s_enc, ms=f"{ms:.4f}", **ab,
          level_ms=json.dumps([round(t, 4) for t in level_ms]),
          level_sum_ms=f"{sum(level_ms):.4f}", plain_ms=f"{plain_ms:.4f}",
          gather_kernel_ms=f"{gather_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
          bound_by=bound_by)
    return dict(max_abs_err=errs[("captured call", bf16)], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, entry_ms=ab["entry_ms"],
                old_ms=ab["old_ms"],
                old_kernel_alone_ms=ab["old_kernel_alone_ms"],
                level_ms=level_ms, gather_kernel_ms=gather_ms)


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
    tracks are born on frame 0 and the track slots fill. A softmax head
    (vanilla DETR, 21 classes) gets a class-0 bias of 4, which puts the
    person's probability near 0.6."""
    from trackformer_tpu_torch.models import build_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model, postprocess = build_model(cfg, "cuda", generator=gen)
    heads = (model.class_embed if isinstance(model.class_embed,
                                             torch.nn.ModuleList)
             else [model.class_embed])
    with torch.no_grad():
        for cls in heads:
            cls.bias[0] = 1.0 if cfg.focal_loss else 4.0
    torch.cuda.synchronize()
    phase(tag, model=type(model).__name__, encoder=cfg.encoder_attention,
          cached_memory=cfg.cached_prev_memory, hidden=cfg.hidden_dim,
          layers=f"{cfg.enc_layers}+{cfg.dec_layers}",
          queries=cfg.num_queries, dtype=cfg.compute_dtype,
          params=sum(p.numel() for p in model.parameters()),
          build_s=f"{time.perf_counter() - t0:.2f}",
          override=f"class_embed.*.bias[0]={heads[0].bias[0].item():g} "
                   f"(smoke only)")
    return model, postprocess


def tracker_run(tag: str, cfg, model, postprocess, n_frames: int,
                seed: int, per_frame: dict, blobs=None):
    """The port's `Tracker` over synthetic frames (`blobs`, by default the
    drifting texture); checks the launches of the run against `per_frame`
    launches per frame for every wrapper -> (launches, results)."""
    from trackformer_tpu_torch.tracking import Tracker

    tracker = Tracker(model, postprocess,
                      {**cfg.tracker_cfg, "max_tracks": cfg.max_tracks},
                      cfg.hidden_dim, cfg.num_queries,
                      overflow_boxes=cfg.overflow_boxes,
                      with_masks=cfg.masks)
    blobs = blobs or frame_blobs(n_frames, seed)
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
    return counts, results


# launches per frame (or lockstep step) of the fast paths: per encoder
# layer one call of the window layer, its five stage kernels in bfloat16;
# one decoder MSDA call per decoder layer
FAST_PER_FRAME = {"fused_window_layer": 6, "window_layer_qkv": 6,
                  "window_layer_attn": 6, "window_layer_proj_ln": 6,
                  "window_layer_ffn1": 6, "window_layer_ffn2_ln": 6,
                  "ms_deform_attn": 6}


def batched_run(cfg, model, postprocess, n_seqs: int, n_frames: int,
                seed: int, tag: str = "fast_batched"):
    """`BatchedTracker` over `n_seqs` sequences in lockstep, each from its
    own seed; the launches of `FAST_PER_FRAME` per lockstep step."""
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
    phase(tag, sequences=n_seqs, frames=n_frames,
          image=f"{BUCKET[0]}x{BUCKET[1]}",
          step_ms="[" + ",".join(f"{t:.1f}" for t in step_ms) + "]",
          steady_median_step_ms=f"{steady:.1f}",
          frames_per_s=f"{n_seqs * 1e3 / steady:.1f}",
          tracks_per_seq=[len(r) for r in results],
          live_at_last_frame=live,
          launches=json.dumps(counts, separators=(",", ":")), finite=finite)
    for name, n in counts.items():
        want = FAST_PER_FRAME.get(name, 0) * n_frames
        check(n == want, f"{tag}: {n} {name} launches, want {want}")
    check(finite, f"{tag}: non-finite results")
    check(all(live), f"{tag}: a sequence holds no track: {live}")
    return counts


def reference_run(tag: str, model, n_frames: int,
                  keys=("pred_logits", "pred_boxes", "hs_embed")) -> float:
    """The same weights in float32: the forward on the card (CUDA kernels)
    against the forward on the CPU (plain versions) on a small image, on
    the outputs `keys`; from the second frame on, each device feeds its
    own previous frame's features back."""
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
        for key in keys:
            a, b = a_out[key].cpu(), b_out[key]
            check(bool(torch.isfinite(a).all()), f"{tag}: non-finite {key}")
            err = ((a - b).abs() / (1.0 + b.abs())).max().item()
            worst = max(worst, err)
    phase(tag, reference=f"float32 card vs CPU, 128x192 image, "
          f"{n_frames} frame(s)", outputs=",".join(keys),
          max_scaled_err=f"{worst:.3e}",
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
# a step whose float32 gradients miss the float64 limits on the CPU too
# (the three-frame step with backprop: the trunk's gradient summed over
# three frames): against float64 the card is held to this many times the
# CPU float32 step's own readings, since float32 puts a different element
# across a ReLU kink in each run (NVIDIA H100 80GB HBM3: the card's
# worst element 1.03 times the CPU's)
OWN_READING_MARGIN = 2.0
REF_LIMITS = {"cpu": (1e-3, 2e-3, 1e-2),
              "cpu_float64": (1e-4, 5e-4, 2.5e-3)}


def synthetic_train_pack(cfg, seed: int, step: int, hw=BUCKET,
                         valid=VALID_HW):
    """`TRAIN_BATCH` frame pairs of the drifting texture with
    `TRAIN_OBJECTS` (less two on the second image) drifting boxes each and
    their track ids, padded to `cfg.max_objects` slots; frames of `valid`
    in the `hw` bucket. For a mask model (`cfg.masks`) each box's target
    mask is its rectangle at the bucket's size (`box_masks`)."""
    from trackformer_tpu_torch.structures import FrameBatch, empty_targets

    b, t = TRAIN_BATCH, cfg.max_objects
    pairs = [synthetic_frames(2, seed + 1000 * step + 10 * i, hw, valid)
             for i in range(b)]
    valid_hw = torch.tensor([valid] * b)
    rng = np.random.RandomState(seed + step)
    scale = np.array([valid[1] / hw[1], valid[0] / hw[0]])
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
        if cfg.masks:
            targets.masks = box_masks(targets.boxes, valid, hw)
        batch = FrameBatch.from_images(
            torch.cat([p[frame] for p in pairs]), valid_hw)
        packs.append((batch, targets))
    return {"prev_batch": packs[0][0], "prev_targets": packs[0][1],
            "batch": packs[1][0], "targets": packs[1][1]}


def box_masks(boxes: torch.Tensor, valid, hw) -> torch.Tensor:
    """(B, T, H, W) bool masks at the bucket size `hw`: each normalized
    cxcywh box's rectangle in an image of `valid` (h, w) at the top left."""
    h, w = valid
    x0 = (boxes[..., 0] - boxes[..., 2] / 2) * w
    x1 = (boxes[..., 0] + boxes[..., 2] / 2) * w
    y0 = (boxes[..., 1] - boxes[..., 3] / 2) * h
    y1 = (boxes[..., 1] + boxes[..., 3] / 2) * h
    ys = torch.arange(hw[0], device=boxes.device)[:, None] + 0.5
    xs = torch.arange(hw[1], device=boxes.device)[None] + 0.5
    rows = (ys >= y0[..., None, None]) & (ys < y1[..., None, None])
    return rows & (xs >= x0[..., None, None]) & (xs < x1[..., None, None])


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


def train_reference_run(seed: int, fast: bool = False, base=None,
                        label: str = None, tracking: bool = True,
                        own_share: bool = False, prev_prev: bool = False):
    """One float32 train step at 128x192, 2 + 2 layers, full width, on the
    card (kernels) against the same step on the CPU (plain versions) in
    float32 and in float64, with dropout 0 and the track-query draws
    pinned: loss, grad_norm and every gradient, name by name, within
    `REF_LIMITS`. The CPU's float32 step is also read against its float64
    step (no check): that reading shows whose the misses of the
    elementwise bound are. `fast`: the TPU-fast mode (its windowed encoder
    on its training path, the decoder's MSDA on the kernels); `base`
    another model's config (the two-stage model), under `label`, its step
    a tracking one or not. With `own_share` the share of elements past the
    elementwise bound against float64 may reach the CPU float32 step's own
    share against float64 (the card no less exact than the plain version
    in float32; the two-stage step, whose `_enc` focal loss over 22,323
    proposals sums thousands of terms, misses the fixed share on the CPU
    too); the per-tensor L2 and largest-error limits stay as they are.
    `prev_prev`: a three-frame step with `backprop_prev_frame`, the
    previous frame's track queries pinned too; against float64 each of the
    three limits may then reach `OWN_READING_MARGIN` times the CPU float32
    step's own reading against float64 under the same limits (the card's
    float32 error of float32's size: the trunk's gradient summed over three
    frames misses the fixed float64 limits on the CPU as well)."""
    import copy
    import dataclasses

    from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                              make_train_step)
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.models.deformable_transformer import \
        MSDeformAttnModule
    from trackformer_tpu_torch.structures import FrameBatch, empty_targets
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    t, n_obj = 10, 7
    label = label or ("train_fast_reference" if fast else "train_reference")
    if base is None:
        base = (FlagshipConfig.tpu_fast() if fast else FlagshipConfig()
                ).replace(dataset="mot_crowdhuman")
    cfg = base.replace(compute_dtype="float32", enc_layers=2, dec_layers=2,
                       num_queries=100, max_objects=t, dropout=0.0)
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
    if prev_prev:
        imgs.append(torch.from_numpy(rng.randn(TRAIN_BATCH, 128, 192, 3)
                                     .astype(np.float32)))
        forced["prev"] = {"num": 5,
                          "order": np.tile(np.arange(t), (TRAIN_BATCH, 1))}
        track_cfg = dataclasses.replace(track_cfg, backprop_prev_frame=True)
    results = {}
    for tag, dev, dtype in (("card", "cuda", torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu_float64", "cpu", torch.float64)):
        model = copy.deepcopy(cpu_model).to(dev, dtype)
        optimizer = make_optimizer(cfg, model)
        state = TrainState.create(model, optimizer)
        step_fn = make_train_step(model, crit_cfg, optimizer, track_cfg,
                                  tracking=tracking, return_grads=True,
                                  prev_prev=prev_prev)
        targets = empty_targets(TRAIN_BATCH, t, dev)
        targets.boxes[:] = torch.from_numpy(boxes).to(dev)
        targets.valid[:, :n_obj] = True
        targets.track_ids[:, :n_obj] = torch.arange(n_obj, dtype=torch.int32)
        valid = torch.tensor([[120, 180]] * TRAIN_BATCH)
        pack = {"prev_batch": FrameBatch.from_images(imgs[0].to(dev), valid),
                "prev_targets": targets,
                "batch": FrameBatch.from_images(imgs[1].to(dev), valid),
                "targets": targets}
        if not tracking:
            pack = {"batch": pack["batch"], "targets": targets}
        if prev_prev:
            pack.update(prev_prev_batch=FrameBatch.from_images(
                imgs[2].to(dev), valid), prev_prev_targets=targets)
        reset_launch_counts()
        _, metrics = step_fn(state, pack, None, forced=forced)
        results[tag] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                        {k: v.cpu() for k, v in metrics["_grads"].items()},
                        launch_counts())
        del model, state, step_fn, metrics
    loss_c, norm_c, grads_c, counts = results["card"]
    for name, got in grads_c.items():
        check(bool(torch.isfinite(got).all()),
              f"{label}: non-finite gradient {name}")
    phase(label, seed=seed, step="float32, 128x192, 2+2 layers, "
          "B=2", gradients=len(grads_c),
          **{f"{k}_{tag}": f"{results[tag][i]:.6f}"
             for i, k in enumerate(("loss", "grad_norm")) for tag in results},
          card_launches=json.dumps({k: v for k, v in counts.items() if v},
                                   separators=(",", ":")))
    if fast:
        launched = (counts["msda_bwd"] > 0 and counts["ms_deform_attn"] > 0
                    and counts["fused_window_layer"] == 0)
    else:
        launched = counts["msda_bwd"] > 0 and counts["msda_patch"] > 0
    check(launched, f"{label}: the card's step launched {counts}")
    failed = []
    own = grad_readings(results["cpu"][2], results["cpu_float64"][2],
                        REF_LIMITS["cpu"])
    for ref in ("cpu", "cpu_float64"):
        loss_r, norm_r, grads_r, _ = results[ref]
        scalars_ok = (
            abs(loss_c - loss_r) <= REF_LOSS_RTOL * max(1.0, abs(loss_r))
            and abs(norm_c - norm_r) <= REF_LOSS_RTOL * max(1.0, abs(norm_r)))
        limits = REF_LIMITS[ref]
        if own_share and ref == "cpu_float64":
            limits = (max(limits[0], own["elements_out"] / own["elements"]),
                      ) + limits[1:]
        if prev_prev and ref == "cpu_float64":
            own64 = grad_readings(results["cpu"][2], grads_r, limits)
            m = OWN_READING_MARGIN
            limits = (max(limits[0], m * own64["elements_out"]
                          / own64["elements"]),
                      limits[1] * max(1.0, m * float(
                          own64["worst_l2_err_over_tol"])),
                      limits[2] * max(1.0, m * float(
                          own64["worst_max_err_over_tol"])))
            phase(label, seed=seed, reading="cpu against cpu_float64 at "
                  "its limits (no check)", **own64)
        r = grad_readings(grads_c, grads_r, limits)
        r["ok"] = r["ok"] and scalars_ok
        phase(label, seed=seed, held=f"card against {ref}",
              loss_grad_norm_tol=f"{REF_LOSS_RTOL:g}*max(1,|ref|)", **r)
        if not r["ok"]:
            failed.append(ref)
    phase(label, seed=seed, reading="cpu against cpu_float64 (no check)",
          **own)
    check(not failed, f"{label} seed {seed}: the card's step differs from "
                      f"{failed}")


# --------------------------------------------------------------------------
# training the TPU-fast mode, checkpoints, evaluation
# --------------------------------------------------------------------------

# launches of one fast-mode train step: the decoder's MSDA calls of both
# frames' forwards (6 each) and the current frame's backward (6). The
# windowed encoder trains on its module path: no window-layer kernel
FAST_TRAIN_PER_STEP = {"ms_deform_attn": 12, "msda_bwd": 6}
# the resumed third step against the uninterrupted one. Measured on the
# card (`chip_resume_drift.py`, NVIDIA H100 80GB HBM3, 700 W): the
# forward is deterministic, so the loss is equal; the backward kernel's
# float32 atomics, and nothing else (with its outputs pinned two replays of
# the step are bit-equal), move grad_norm by 4.4e-6 to 7.6e-6 relative,
# the same between two replays of the step in memory as after a restore
RESUME_RTOL = {"loss": 1e-6, "grad_norm": 1e-4}


def max_rel_diff(a: dict, b: dict) -> float:
    """The largest |a - b|_2 / |b|_2 over the tensors of two dicts."""
    return max(((a[k].float() - b[k].float()).norm()
                / b[k].float().norm().clamp(min=1e-30)).item() for k in b)


def fast_train_run(seed: int, with_checkpoint: bool, out_dir: Path):
    """The full-width TPU-fast flagship in bfloat16 trains: B = 2 frame
    pairs at 800x1344 with `train.yaml`'s training fields and `tpu_fast`'s
    warmup, 3 optimizer steps (finite losses, the launches of
    `FAST_TRAIN_PER_STEP`, step ms, peak memory); then a deterministic
    (eval-mode) forward of the same model launches kernel #8 on every
    windowed layer. With `with_checkpoint`, `CheckpointManager` saves the
    state after the second step; a fresh model and state restored from it
    hold the saved tensors bit for bit, and their third step, with the
    same draws, lands within `RESUME_RTOL` of the uninterrupted one (the
    backward kernel's sums are not bitwise reproducible)."""
    from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                              make_train_step)
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.utils.checkpoint import CheckpointManager
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    cfg = FlagshipConfig.tpu_fast(dataset="mot_crowdhuman")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model, crit_cfg, _, track_cfg = build_model(cfg, "cuda", generator=gen,
                                                train=True)
    optimizer = make_optimizer(cfg, model)
    state = TrainState.create(model, optimizer)
    step_fn = make_train_step(model, crit_cfg, optimizer, track_cfg,
                              tracking=True)
    phase("train_fast", model="flagship TPU-fast (windowed encoder, cached "
          "memory)", dtype=cfg.compute_dtype, batch=TRAIN_BATCH,
          image=f"{BUCKET[0]}x{BUCKET[1]}", queries=cfg.num_queries,
          dropout=cfg.dropout, lr_warmup_steps=cfg.lr_warmup_steps,
          tensors=len(optimizer.labels),
          params=sum(p.numel() for p in model.parameters()))
    gen.manual_seed(seed + 1)
    torch.cuda.reset_peak_memory_stats()
    step_ms, saved, save_s, draws, last = [], None, None, None, None
    for step in range(3):
        pack = synthetic_train_pack(cfg, seed, step)
        if step == 2 and with_checkpoint:
            saved = {name: {k: v.clone() for k, v in
                            getattr(state, name).items()}
                     for name in ("params", "mu", "nu")}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            CheckpointManager(out_dir, save_interval=1).save(
                state, 2, {"neg_loss": -last["loss"]}, cfg)
            save_s = time.perf_counter() - t0
            draws = gen.get_state()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, pack, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = launch_counts()
        record_path()
        last = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in last.items() if not np.isfinite(v)]
        phase("train_fast", step=step, loss=f"{last['loss']:.4f}",
              grad_norm=f"{last['grad_norm']:.4f}",
              lr_scale=f"{optimizer.lr_scale(step):g}",
              step_ms=f"{step_ms[-1]:.1f}",
              launches=json.dumps({k: v for k, v in counts.items() if v},
                                  separators=(",", ":")))
        check(not bad, f"train_fast step {step}: non-finite {bad}")
        check(last["grad_norm"] > 0, "train_fast: zero gradient")
        for name, n in counts.items():
            check(n == FAST_TRAIN_PER_STEP.get(name, 0),
                  f"train_fast step {step}: {n} {name} launches, want "
                  f"{FAST_TRAIN_PER_STEP.get(name, 0)}")
    phase("train_fast", steps=3,
          steady_median_step_ms=f"{statistics.median(step_ms[1:]):.1f}",
          peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    # deterministic calls of the trained model: kernel #8 on every layer
    model.eval()
    reset_launch_counts()
    with torch.inference_mode():
        out = model(pack["batch"])[0]
    counts = launch_counts()
    record_path()
    model.train()
    phase("train_fast", deterministic_forward=f"eval mode, B = {TRAIN_BATCH}",
          finite=bool(torch.isfinite(out["pred_logits"]).all()),
          launches=json.dumps({k: v for k, v in counts.items() if v},
                              separators=(",", ":")))
    for name, n in counts.items():
        check(n == FAST_PER_FRAME.get(name, 0),
              f"train_fast eval forward: {n} {name} launches, want "
              f"{FAST_PER_FRAME.get(name, 0)}")
    if not with_checkpoint:
        return

    fresh, _, _, _ = build_model(cfg, "cuda", train=True)
    fresh_state = TrainState.create(fresh, make_optimizer(cfg, fresh))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh_state, epoch = CheckpointManager(out_dir).restore(fresh_state,
                                                            fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    unequal = [f"{name}:{k}" for name, tensors in saved.items()
               for k, t in tensors.items()
               if not torch.equal(getattr(fresh_state, name)[k], t)]
    model_tensors = dict(fresh.named_parameters())
    unequal += [k for k, t in saved["params"].items() if k in model_tensors
                and not torch.equal(model_tensors[k],
                                    t.to(model_tensors[k].dtype))]
    resume_fn = make_train_step(fresh, crit_cfg, make_optimizer(cfg, fresh),
                                track_cfg, tracking=True)
    gen.set_state(draws)
    reset_launch_counts()
    fresh_state, metrics = resume_fn(fresh_state, pack, gen)
    counts = launch_counts()
    record_path()
    resumed = {k: float(v) for k, v in metrics.items()}
    pairs = {k: (last[k], resumed[k]) for k in ("loss", "grad_norm")}
    ok = all(abs(b - a) <= RESUME_RTOL[k] * abs(a)
             for k, (a, b) in pairs.items())
    phase("checkpoint", state=f"train_fast after step 2, {len(saved['params'])}"
          " tensors", epoch=epoch, save_s=f"{save_s:.3f}",
          restore_s=f"{restore_s:.3f}",
          files=sorted(p.name for p in Path(out_dir).iterdir()),
          restored_bit_equal=not unequal, step=fresh_state.step,
          **{f"third_step_{k}_{tag}": f"{v:.6f}" for k, ab in pairs.items()
             for tag, v in zip(("uninterrupted", "resumed"), ab)},
          params_max_rel_diff=f"{max_rel_diff(fresh_state.params, state.params):.3e}",
          tol=json.dumps({k: f"{v:g}*|uninterrupted|"
                          for k, v in RESUME_RTOL.items()}), ok=ok)
    check(not unequal, f"checkpoint: restored tensors differ: {unequal[:5]}")
    check(epoch == 2 and fresh_state.step == 3, "checkpoint: epoch/step")
    check(ok, f"checkpoint: resumed third step against the uninterrupted "
              f"one: {pairs}")
    for name, n in counts.items():
        check(n == FAST_TRAIN_PER_STEP.get(name, 0),
              f"checkpoint resumed step: {n} {name} launches")


def npz_round_trip(cfg, seed: int, tag: str, out_dir: Path):
    """The full-width model with seeded weights through an `.npz` in the
    JAX layout (`save_model_npz`) into a fresh model (`load_model_npz`):
    a forward on one frame is bit-equal. Prints the file's size and the
    save and load seconds."""
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.utils.checkpoint import (load_model_npz,
                                                        save_model_npz)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = build_model(cfg, "cuda", generator=gen)[0]
    blob = frame_blobs(1, seed)[0]
    outs, launches = [], []
    path = Path(out_dir) / f"{tag}.npz"
    for run in range(2):
        if run:
            t0 = time.perf_counter()
            save_model_npz(model, path, cfg)
            save_s = time.perf_counter() - t0
            del model
            model = build_model(cfg, "cuda")[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            load_model_npz(model, path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        reset_launch_counts()
        with torch.inference_mode():
            outs.append(model(blob["batch"])[0])
        launches.append(launch_counts())
        record_path()
    equal = all(torch.equal(outs[0][k], outs[1][k])
                for k in ("pred_logits", "pred_boxes", "hs_embed"))
    phase("checkpoint", mode=tag, npz_mib=f"{path.stat().st_size / 2**20:.1f}",
          save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}",
          forward_bit_equal=equal,
          launches=json.dumps({k: v for k, v in launches[1].items() if v},
                              separators=(",", ":")))
    check(equal, f"checkpoint {tag}: the reloaded model's forward differs")
    check(launches[0] == launches[1], f"checkpoint {tag}: launches differ")
    path.unlink()


# moving rectangles of the evaluate phase: (x, y, w, h) at the original
# 1080x1920 size on the first frame, and their (dx, dy) per frame
RECTS = ((300.0, 250.0, 160.0, 320.0), (900.0, 400.0, 220.0, 180.0),
         (1400.0, 600.0, 120.0, 260.0))
RECT_STEP = ((12.0, 4.0), (-8.0, 6.0), (5.0, -10.0))
ORIG_HW = (1080, 1920)


def rect_frames(n_frames: int, seed: int):
    """The drifting texture with `RECTS` painted on, moving by `RECT_STEP`
    a frame: (blobs for the tracker and `evaluate`, ground truth per frame
    as {id: xyxy at the original size})."""
    scale = VALID_HW[0] / ORIG_HW[0]
    frames, gts = [], []
    for t, img in enumerate(synthetic_frames(n_frames, seed)):
        gt = {}
        for i, ((x, y, w, h), (dx, dy)) in enumerate(zip(RECTS, RECT_STEP)):
            x, y = x + dx * t, y + dy * t
            gt[i] = np.array([x, y, x + w, y + h], np.float32)
            x0, y0, x1, y1 = (int(round(v * scale)) for v in gt[i])
            img[:, y0:y1, x0:x1] = 2.0 * (i % 2) - 1.0
        frames.append(img)
        gts.append(gt)
    return frames, gts


def evaluate_run(cfg, seed: int, tag: str, per_frame: dict,
                 n_frames: int = 4, track: bool = True):
    """`evaluate` on the full-width model in bfloat16 over 4 frames of
    moving rectangles, their boxes the planted ground truth (seconds per
    frame, the stats, each frame's launches); 6 frames of `Tracker` on the
    moving rectangles, scored with `get_mot_accum` and `summarize` (MOTA,
    IDF1: random weights, so the numbers are plumbing, not accuracy); then
    `make_results` of the eval forward held on the card against the CPU's
    (float32, the same weights, 4 frames at 128x192) within `SLICE_TOL`.
    `n_frames` evaluated frames; without `track` (a two-stage model, which
    no tracker takes) no `Tracker` run."""
    import types

    from trackformer_tpu_torch.engine.loop import evaluate, make_results
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.models.factory import train_configs
    from trackformer_tpu_torch.structures import FrameBatch, empty_targets
    from trackformer_tpu_torch.utils.track_utils import (evaluate_mot_accums,
                                                         get_mot_accum)

    model, post = smoke_model(cfg, seed, tag)
    crit_cfg = train_configs(cfg)[0]
    frames, gts = rect_frames(n_frames, seed)
    valid = torch.tensor([VALID_HW])
    packs, anns = [], {}
    for i, (img, gt) in enumerate(zip(frames, gts)):
        targets = empty_targets(1, cfg.max_objects, "cuda")
        boxes = np.stack([gt[k] for k in sorted(gt)])
        cxcywh = np.concatenate([(boxes[:, :2] + boxes[:, 2:]) / 2,
                                 boxes[:, 2:] - boxes[:, :2]], 1)
        cxcywh /= np.array([ORIG_HW[1], ORIG_HW[0]] * 2, np.float32)
        targets.boxes[0, :len(gt)] = torch.from_numpy(cxcywh).cuda()
        targets.valid[0, :len(gt)] = True
        targets.orig_size[:] = torch.tensor(ORIG_HW)
        targets.size[:] = torch.tensor(VALID_HW)
        targets.image_id[:] = i
        packs.append({"batch": FrameBatch.from_images(img, valid),
                      "targets": targets})
        anns[i] = [{"bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]),
                             float(b[3] - b[1])], "category_id": 1,
                    "iscrowd": 0, "area": float((b[2] - b[0]) * (b[3] - b[1]))}
                   for b in boxes]
    gt_dataset = types.SimpleNamespace(anns_by_image=anns)
    args = types.SimpleNamespace(num_queries=cfg.num_queries,
                                 vis_and_log_interval=n_frames)
    evaluate(model, crit_cfg, {"bbox": post}, packs[:1], lambda p: p,
             gt_dataset, args)      # warm-up: first calls, cuBLAS plans
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    stats = evaluate(model, crit_cfg, {"bbox": post}, packs, lambda p: p,
                     gt_dataset, args)
    torch.cuda.synchronize()
    s_per_frame = (time.perf_counter() - t0) / n_frames
    counts = launch_counts()
    record_path()
    phase("evaluate", mode=tag, frames=n_frames,
          image=f"{BUCKET[0]}x{BUCKET[1]}", s_per_frame=f"{s_per_frame:.4f}",
          AP=f"{stats['AP']:.4f}", AP50=f"{stats['AP50']:.4f}",
          coco_eval_bbox=json.dumps([round(v, 4) for v in
                                     stats["coco_eval_bbox"]]),
          loss_ce=f"{stats['loss_ce']:.4f}",
          launches=json.dumps({k: v for k, v in counts.items() if v},
                              separators=(",", ":")))
    check(all(np.isfinite(v) for k, v in stats.items()
              if k != "coco_eval_bbox")
          and len(stats["coco_eval_bbox"]) == 12,
          f"evaluate {tag}: stats {stats}")
    for name, n in counts.items():
        want = per_frame.get(name, 0) * n_frames
        check(n == want, f"evaluate {tag}: {n} {name} launches, want {want}")

    # tracking of the moving rectangles, scored as the track CLI scores it
    if track:
        frames, gts = rect_frames(6, seed + 7)
        blobs = [{"batch": FrameBatch.from_images(img, valid),
                  "orig_size": torch.tensor([ORIG_HW])} for img in frames]
        _, results = tracker_run(f"evaluate_{tag}_tracker", cfg, model, post,
                                 len(blobs), seed, per_frame, blobs=blobs)
        acc = get_mot_accum(results, _Sequence(gts, f"rectangles_{tag}"))
        summary = evaluate_mot_accums([acc])["OVERALL"]
        phase("evaluate", mode=tag,
              tracking="6 frames of 3 moving rectangles",
              mota=f"{summary['mota']:.4f}", idf1=f"{summary['idf1']:.4f}",
              num_switches=summary["num_switches"],
              num_false_positives=summary["num_false_positives"],
              num_misses=summary["num_misses"])
        check(np.isfinite(summary["mota"]) and np.isfinite(summary["idf1"]),
              f"evaluate {tag}: MOT summary {summary}")

    # the same results on the card and on the CPU: float32, small frames
    model32 = model.float()
    rng = np.random.RandomState(seed)
    small = [torch.from_numpy(rng.randn(1, 128, 192, 3).astype(np.float32))
             for _ in range(n_frames)]
    got = {}
    for dev in ("cuda", "cpu"):
        model32.to(dev)
        got[dev] = []
        for i, img in enumerate(small):
            targets = empty_targets(1, 1, dev)
            targets.orig_size[:] = torch.tensor([240, 360])
            targets.image_id[:] = i
            with torch.inference_mode():
                out = model32(FrameBatch.from_images(
                    img.to(dev), torch.tensor([[120, 180]])))[0]
            got[dev].append(make_results(out, targets, post,
                                         cfg.num_queries)[i])
    worst, same_label, slots = 0.0, 0, 0
    for a, b in zip(got["cuda"], got["cpu"]):
        for key, norm in (("scores", 1.0), ("boxes", 360.0)):
            err = np.abs(a[key] - b[key]) / (norm + np.abs(b[key]))
            worst = max(worst, float(err.max()))
        same_label += int((a["labels"] == b["labels"]).sum())
        slots += a["labels"].size
    agree = same_label / slots
    phase("evaluate", mode=tag, held="make_results, float32 card vs CPU, "
          f"128x192, {n_frames} frames", max_scaled_err=f"{worst:.3e}",
          tol=SLICE_TOL, labels_agree=f"{same_label}/{slots}",
          ok=worst <= SLICE_TOL and agree >= 0.99)
    check(worst <= SLICE_TOL and agree >= 0.99,
          f"evaluate {tag}: card vs CPU results differ: {worst}, "
          f"{same_label}/{slots} labels")
    del model, model32


# --------------------------------------------------------------------------
# the serving entry point: `cli.track` over MOTChallenge-layout sequences
# --------------------------------------------------------------------------

# sequence names the dataset registry knows; the frames of all of them are
# written under train/
MOT17_NAMES = ("MOT17-02-FRCNN", "MOT17-04-FRCNN", "MOT17-05-FRCNN",
               "MOT17-09-FRCNN", "MOT17-10-FRCNN", "MOT17-11-FRCNN",
               "MOT17-13-FRCNN", "MOT17-01-FRCNN")


def png_bytes(img: np.ndarray) -> bytes:
    """uint8 (H, W, 3) -> an RGB PNG file's bytes, every row unfiltered."""
    import struct
    import zlib

    h, w, _ = img.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def png_row_filters(data: bytes) -> list:
    """The row filters (0-4) an 8-bit RGB PNG file's bytes use, sorted."""
    import struct
    import zlib

    pos, idat, w = 8, [], 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w = struct.unpack(">I", data[pos + 8:pos + 12])[0]
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return sorted(set(raw.reshape(-1, 1 + 3 * w)[:, 0].tolist()))


def read_frame_ms(path: Path, reps: int = 5) -> float:
    """The median ms of `read_frame(path)`."""
    from trackformer_tpu_torch.datasets.image_io import read_frame

    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        read_frame(path)
        times.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(times)


def write_mot_sequences(root: Path, names, n_frames: int, hw=ORIG_HW,
                        seed: int = 0, ext: str = "png",
                        mots: bool = False) -> None:
    """MOTChallenge-layout sequences under root/MOT17/train/<name>: PNG
    frames written by `png_bytes` (or, with `ext="jpg"`, JPEGs written by
    Pillow, MOT17's format) of a seeded blocky texture drifting a few
    pixels a frame, with the three rectangles of `RECTS` scaled to `hw`,
    each with its own seeded colour and texture, moving by `RECT_STEP`;
    `seqinfo.ini`, `gt/gt.txt` (the rectangles, 1-based ids) and
    `det/det.txt` (the same boxes). With `mots` the layout is MOTS20's,
    root/MOTS20/train/<name>, without `det/`, and `gt/gt.txt` holds each
    rectangle's mask (its top-left corner cut off) as a MOTS line of a
    pedestrian 2001.., written by the port's `mots_line`."""
    h, w = hw
    sy, sx = h / ORIG_HW[0], w / ORIG_HW[1]
    if mots:
        from trackformer_tpu_torch.datasets.tracking.mots20_sequence import \
            mots_line
    for k, name in enumerate(names):
        rng = np.random.RandomState(seed + 1000 * k)
        base = np.repeat(np.repeat(rng.randint(
            0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8), 8, 0),
            8, 1)[:h, :w]
        colours = rng.randint(0, 256, (len(RECTS), 3))
        seq_dir = root / ("MOTS20" if mots else "MOT17") / "train" / name
        (seq_dir / "img1").mkdir(parents=True)
        (seq_dir / "gt").mkdir()
        gt_lines, det_lines = [], []
        for t in range(n_frames):
            img = np.roll(base, (3 * t, 5 * t), (0, 1))
            for i, ((x, y, bw, bh), (dx, dy)) in enumerate(zip(RECTS,
                                                               RECT_STEP)):
                x0 = int(round((x + dx * t + 7 * k) * sx))
                y0 = int(round((y + dy * t + 5 * k) * sy))
                bw, bh = max(2, int(round(bw * sx))), max(2, int(round(
                    bh * sy)))
                patch = img[y0:y0 + bh, x0:x0 + bw].astype(np.int32)
                img[y0:y0 + bh, x0:x0 + bw] = (
                    colours[i] * 3 + patch) // 4
                if mots:
                    mask = np.zeros((h, w), bool)
                    mask[y0:y0 + bh, x0:x0 + bw] = True
                    mask[y0:y0 + bh // 4, x0:x0 + bw // 4] = False
                    gt_lines.append(mots_line(t + 1, 2001 + i, 2,
                                              mask).rstrip("\n"))
                else:
                    gt_lines.append(f"{t + 1},{i + 1},{x0 + 1},{y0 + 1},"
                                    f"{bw},{bh},1,1,1.0")
                det_lines.append(f"{t + 1},-1,{x0 + 1},{y0 + 1},{bw},{bh},"
                                 f"0.9")
            frame = seq_dir / "img1" / f"{t + 1:06d}.{ext}"
            if ext == "png":
                frame.write_bytes(png_bytes(img))
            else:
                from PIL import Image
                Image.fromarray(img).save(frame, quality=95)
        (seq_dir / "gt" / "gt.txt").write_text("\n".join(gt_lines) + "\n")
        if not mots:
            (seq_dir / "det").mkdir()
            (seq_dir / "det" / "det.txt").write_text("\n".join(det_lines)
                                                     + "\n")
        (seq_dir / "seqinfo.ini").write_text(
            f"[Sequence]\nname = {name}\nimDir = img1\nframeRate = 30\n"
            f"seqLength = {n_frames}\nimWidth = {w}\nimHeight = {h}\n"
            f"imExt = .{ext}\n")


def nonzero(counts: dict) -> str:
    return json.dumps({k: v for k, v in counts.items() if v},
                      separators=(",", ":"))


def track_argv(names, root: Path, checkpoint: Path, *extra) -> list:
    """`cli.track`'s command line over the named sequences."""
    return ["with", "dataset_name=[" + ",".join(names) + "]",
            f"data_root_dir={root}",
            f"obj_detect_checkpoint_file={checkpoint}", *extra]


def cli_main(tag: str, argv: list):
    """`cli.track.main(argv)` on the card: its lines printed under `tag`
    -> (its MOT summary, its RUNTIME ALL SEQS line as (seconds, frames,
    Hz, [Hz of each sequence's RUNTIME line]))."""
    import contextlib
    import io
    import re

    from trackformer_tpu_torch.cli.track import main as track_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = track_main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip() and not line.startswith((" ", "MOT17", "OVERALL")):
            print(f"[{tag}] cli: {line}", flush=True)
    found = re.search(r"RUNTIME ALL SEQS[^:]*: ([\d.]+) s for (\d+) frames "
                      r"\(([\d.]+) Hz\)", text)
    per_seq = [float(hz) for hz in re.findall(
        r"^RUNTIME: [\d.]+ s \(([\d.]+) Hz\)", text, re.M)]
    runtime = None if found is None else (float(found[1]), int(found[2]),
                                          float(found[3]), per_seq)
    return summary, runtime


def cli_checkpoint(cfg, named, seed: int, tag: str, out_dir: Path):
    """The smoke model of `cfg` saved as the CLI loads it: the weights as an
    `.npz` in the JAX layout, and beside them the train config (train.yaml
    with the named configs) that `FlagshipConfig.from_config` maps back
    onto `cfg` -> (model, postprocess, checkpoint path)."""
    from trackformer_tpu_torch.utils.checkpoint import save_model_npz
    from trackformer_tpu_torch.utils.config import (FlagshipConfig,
                                                    dump_config, load_config)

    train_cfg = load_config("train.yaml", named, {"dataset": cfg.dataset})
    # `tpu.remat` (on in train.yaml) is a training knob: no forward reads it
    check(FlagshipConfig.from_config(train_cfg).replace(remat=cfg.remat)
          == cfg,
          f"{tag}: the saved train config does not map onto the model's")
    model, post = smoke_model(cfg, seed, tag)
    ckpt = out_dir / tag / "checkpoint.npz"
    save_model_npz(model, ckpt, cfg)
    dump_config(train_cfg, ckpt.parent / "config.yaml")
    return model, post, ckpt


def cli_launches(tag: str, counts: dict, per_frame: dict, n: int) -> None:
    """The run's launches are `per_frame` for each of `n` frames (or
    lockstep steps), and every MSDA launch was at the CLI frames' levels."""
    from trackformer_tpu_torch.ops import msda
    for name, got in counts.items():
        want = per_frame.get(name, 0) * n
        check(got == want, f"{tag}: {got} {name} launches, want {want}")
    levels = {key[3] for key in msda.launch_shapes()}
    check(levels <= {CLI_LEVELS, CLI_LEVELS * 2},
          f"{tag}: MSDA launched at levels {sorted(levels)}")


def track_cli_run(seed: int, exact_cfg, fast_cfg, tmp: Path) -> dict:
    """`cli.track.main` on the card, as a user calls it, over sequences of
    1080x1920 PNG frames (768x1344 after the eval transform):
      exact, B = 1: the exact model over 2 sequences of 8 frames; one
         result file per sequence; 12 `msda_patch` and 6 `ms_deform_attn`
         launches a frame; the CLI's Hz; its tracks against the port's
         `Tracker` driven directly over the same blobs (equal ids and
         frames, boxes within 1e-3 px), with that run's frames/s; the
         host's read_frame + preprocess_frame ms a frame and its share of
         the CLI's frame time; read_frame's ms on the same frame written
         by Pillow as a PNG (adaptive row filters) and as a JPEG;
      fast, B = 8: the fast model over 8 sequences of 4 frames with
         `tpu.batch_sequences=8` (`BatchedTracker`): 6 window-layer calls
         (five stage kernels each) and 6 decoder launches a lockstep step;
         frames/s; the host's ms in each step (reading, preprocessing and
         copying its 8 frames); then B = 1 over one of them (the window
         layer at B = 1);
      loaded results: the ground truth written as result files and read
         back through `load_results_dir`: MOTA = IDF1 = 1.
    -> the runs' launch counts by run."""
    from types import SimpleNamespace

    from trackformer_tpu_torch.datasets.image_io import read_frame
    from trackformer_tpu_torch.datasets.tracking import TrackDatasetFactory
    from trackformer_tpu_torch.datasets.tracking.mot17_sequence import (
        eval_resize, preprocess_frame)
    from trackformer_tpu_torch.tracking import Tracker
    from trackformer_tpu_torch.tracking.batched import BatchedTracker

    exact_names, n_exact = MOT17_NAMES[:2], 8
    fast_names, n_fast = MOT17_NAMES, 4
    t0 = time.perf_counter()
    write_mot_sequences(tmp / "exact", exact_names, n_exact, seed=seed)
    write_mot_sequences(tmp / "fast", fast_names, n_fast, seed=seed + 1)
    phase("track_cli", frames=f"{ORIG_HW[0]}x{ORIG_HW[1]} PNG",
          sequences=f"{len(exact_names)}x{n_exact} exact, "
                    f"{len(fast_names)}x{n_fast} fast",
          write_s=f"{time.perf_counter() - t0:.2f}")
    named = ["deformable", "tracking", "multi_frame"]
    model, post, exact_ckpt = cli_checkpoint(exact_cfg, named, seed,
                                             "track_cli_exact", tmp)
    out = tmp / "out_exact"
    exact_per_frame = {"msda_patch": 12, "ms_deform_attn": 6}

    # exact, B = 1: a first run over one sequence meets the 768x1344
    # shapes cold, then the measured run
    cli_main("track_cli_exact_warmup", track_argv(
        exact_names[:1], tmp / "exact", exact_ckpt))
    reset_launch_counts()
    _, runtime = cli_main("track_cli_exact", track_argv(
        exact_names, tmp / "exact", exact_ckpt, f"output_dir={out}"))
    exact_counts = launch_counts()
    cli_launches("track_cli_exact", exact_counts, exact_per_frame,
                 len(exact_names) * n_exact)
    record_path()
    check(runtime is not None and runtime[1] == len(exact_names) * n_exact,
          f"track_cli_exact: runtime line {runtime}")
    files = sorted(p.name for p in out.glob("*.txt"))
    check(files == sorted(f"{n}.txt" for n in exact_names),
          f"track_cli_exact: result files {files}")

    # the same sequences through the port's `Tracker` directly
    dataset = TrackDatasetFactory(
        list(exact_names), root_dir=str(tmp / "exact"),
        img_transform=SimpleNamespace(val_width=exact_cfg.val_width,
                                      max_size=exact_cfg.max_size))
    tracker = Tracker(model, post, {**exact_cfg.tracker_cfg,
                                    "max_tracks": exact_cfg.max_tracks},
                      exact_cfg.hidden_dim, exact_cfg.num_queries,
                      overflow_boxes=exact_cfg.overflow_boxes)
    blobs = [[seq[i] for i in range(len(seq))] for seq in dataset]
    check(all(tuple(b["batch"].images.shape[1:3]) == CLI_BUCKET
              for bs in blobs for b in bs),
          "track_cli: a frame is not padded to 768x1344")
    reset_launch_counts()
    step_ms, worst, n_boxes = [], 0.0, 0
    for seq, seq_blobs in zip(dataset, blobs):
        tracker.reset()
        for blob in seq_blobs:
            t1 = time.perf_counter()
            tracker.step(blob)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        direct, cli = tracker.get_results(), seq.load_results(str(out))
        check({(t, f) for t, v in direct.items() for f in v}
              == {(t, f) for t, v in cli.items() for f in v},
              f"track_cli: {seq}: the CLI's (id, frame) rows differ from "
              f"the Tracker's")
        for t, v in direct.items():
            for f, e in v.items():
                err = np.abs(np.asarray(e["bbox"], np.float64)
                             - np.asarray(cli[t][f]["bbox"])).max()
                worst, n_boxes = max(worst, float(err)), n_boxes + 1
    cli_launches("track_cli_direct", launch_counts(), exact_per_frame,
                 len(step_ms))
    record_path()
    check(n_boxes > 0, "track_cli: no track was born")
    check(worst <= 1e-3, f"track_cli: boxes differ by {worst} px")
    # the host's share: read and preprocess each frame again
    resize = eval_resize(SimpleNamespace(val_width=exact_cfg.val_width,
                                         max_size=exact_cfg.max_size))
    read_ms, pre_ms = [], []
    for seq in dataset:
        for d in seq.data:
            t1 = time.perf_counter()
            img = read_frame(d["im_path"])
            t2 = time.perf_counter()
            preprocess_frame(img, resize)
            read_ms.append((t2 - t1) * 1e3)
            pre_ms.append((time.perf_counter() - t2) * 1e3)
    host_ms = statistics.median(read_ms) + statistics.median(pre_ms)
    frame_ms = 1e3 / runtime[2]
    # read_frame on frames as users have them, at 1080x1920: a PNG that
    # Pillow writes (adaptive row filters) and a JPEG (MOT17's format)
    from PIL import Image
    frame = read_frame(dataset[0].data[0]["im_path"])
    user_png, user_jpg = tmp / "pillow_frame.png", tmp / "pillow_frame.jpg"
    Image.fromarray(frame).save(user_png)
    Image.fromarray(frame).save(user_jpg, quality=95)
    check(read_frame(user_jpg).shape == (*ORIG_HW, 3)
          and np.array_equal(read_frame(user_png), frame),
          "track_cli: a Pillow-written frame does not read back")
    phase("track_cli_exact", batch=1, frames=runtime[1],
          image=f"{CLI_BUCKET[0]}x{CLI_BUCKET[1]}", cli_hz=runtime[2],
          cli_hz_per_sequence=runtime[3], cli_seconds=runtime[0],
          tracker_frames_per_s=f"{1e3 * len(step_ms) / sum(step_ms):.3f}",
          tracker_steady_median_ms=f"{statistics.median(step_ms[1:]):.2f}",
          read_frame_ms=f"{statistics.median(read_ms):.2f}",
          preprocess_frame_ms=f"{statistics.median(pre_ms):.2f}",
          host_share_of_frame=f"{host_ms / frame_ms:.3f}",
          frames_png_filters=png_row_filters(
              Path(dataset[0].data[0]["im_path"]).read_bytes()),
          read_frame_pillow_png_ms=f"{read_frame_ms(user_png):.2f}",
          pillow_png_filters=png_row_filters(user_png.read_bytes()),
          read_frame_jpeg_ms=f"{read_frame_ms(user_jpg):.2f}",
          tracks_equal=True, boxes=n_boxes, max_box_diff_px=f"{worst:.2e}",
          launches=nonzero(exact_counts))

    # loaded results: the ground truth as result files
    gt_dir = tmp / "gt_results"
    for seq in dataset:
        seq.write_results({tid - 1: {f: {"bbox": d["gt"][tid]}
                                     for f, d in enumerate(seq.data)
                                     if tid in d["gt"]}
                           for tid in seq.data[0]["gt"]}, str(gt_dir))
    reset_launch_counts()
    summary, _ = cli_main("track_cli_loaded", track_argv(
        exact_names, tmp / "exact", exact_ckpt, f"load_results_dir={gt_dir}"))
    overall = summary["OVERALL"]
    phase("track_cli_loaded", mota=overall["mota"], idf1=overall["idf1"],
          switches=overall["num_switches"],
          launches=sum(launch_counts().values()))
    check(overall["mota"] == 1.0 and overall["idf1"] == 1.0,
          f"track_cli_loaded: MOTA {overall['mota']} IDF1 {overall['idf1']}")
    check(sum(launch_counts().values()) == 0,
          "track_cli_loaded: a kernel launched with loaded results")
    del model, tracker, blobs

    # fast, B = 8 in lockstep, then B = 1
    model, post, fast_ckpt = cli_checkpoint(
        fast_cfg, named + ["tpu_fast"], seed, "track_cli_fast", tmp)
    del model
    out = tmp / "out_fast"
    cli_main("track_cli_fast_b8_warmup", track_argv(
        fast_names, tmp / "fast", fast_ckpt, "tpu.batch_sequences=8"))
    # the host's time in each lockstep step, timed in the run itself:
    # `_assemble` reads, preprocesses and copies to the card the step's 8
    # frames, after the previous step's results came back
    assemble_ms = []
    assemble = BatchedTracker._assemble

    def timed_assemble(self, *args):
        t1 = time.perf_counter()
        batch = assemble(self, *args)
        assemble_ms.append((time.perf_counter() - t1) * 1e3)
        return batch

    reset_launch_counts()
    BatchedTracker._assemble = timed_assemble
    try:
        _, runtime = cli_main("track_cli_fast_b8", track_argv(
            fast_names, tmp / "fast", fast_ckpt, f"output_dir={out}",
            "tpu.batch_sequences=8"))
    finally:
        BatchedTracker._assemble = assemble
    fast_b8 = launch_counts()
    check(len(assemble_ms) == n_fast,
          f"track_cli_fast_b8: {len(assemble_ms)} lockstep steps")
    cli_launches("track_cli_fast_b8", fast_b8, FAST_PER_FRAME, n_fast)
    record_path()
    files = sorted(p.name for p in out.glob("*.txt"))
    check(files == sorted(f"{n}.txt" for n in fast_names),
          f"track_cli_fast_b8: result files {files}")
    phase("track_cli_fast_b8", batch=8, frames=runtime[1],
          image=f"{CLI_BUCKET[0]}x{CLI_BUCKET[1]}",
          frames_per_s=runtime[2], cli_seconds=runtime[0],
          step_ms=f"{1e3 * runtime[0] / n_fast:.2f}",
          host_assemble_ms=[round(t, 2) for t in assemble_ms],
          host_share_of_steps=f"{sum(assemble_ms) / 1e3 / runtime[0]:.3f}",
          launches=nonzero(fast_b8))
    reset_launch_counts()
    _, runtime = cli_main("track_cli_fast_b1", track_argv(
        fast_names[:1], tmp / "fast", fast_ckpt))
    fast_b1 = launch_counts()
    cli_launches("track_cli_fast_b1", fast_b1, FAST_PER_FRAME, n_fast)
    record_path()
    phase("track_cli_fast_b1", batch=1, frames=runtime[1],
          frames_per_s=runtime[2], cli_seconds=runtime[0],
          launches=nonzero(fast_b1))
    return {"exact": exact_counts, "fast_b8": fast_b8, "fast_b1": fast_b1}


# the training CLI: 2 sequences of 8 1080x1920 JPEG frames (16 training
# samples, 8 steps an epoch at B = 2), validated on the second half of
# each sequence (the first 4 of those 8 frames: `tpu.eval_subset`)
TRAIN_CLI_SEQS = ("MOT17-02-FRCNN", "MOT17-04-FRCNN")
TRAIN_CLI_FRAMES = 8
TRAIN_CLI_EVAL_SUBSET = 4
# launches per exact train step, validation batch and tracked frame
EXACT_STEP = {"msda_patch": 24, "ms_deform_attn": 12, "msda_bwd": 18}
EXACT_FORWARD = {"msda_patch": 12, "ms_deform_attn": 6}
# under `tpu.remat` (train.yaml's, which the train CLI applies) the current
# frame's 12 encoder layer calls run again in the backward
REMAT_STEP = {**EXACT_STEP, "msda_patch": 36}


def train_cli_run(seed: int, tmp: Path, card: str) -> dict:
    """`cli.train.main` on the card as a user runs it: a MOTChallenge-layout
    dataset of 1080x1920 JPEGs (`TRAIN_CLI_SEQS`, one of them named as the
    tracking registry knows it), converted by the port's
    `generate_coco_from_mot` (the three splits of its `main`); then the
    full-width exact flagship (`deformable tracking multi_frame`, bf16,
    B = 2) trained 2 epochs with a validation each (box AP of
    `tpu.eval_subset` frames of the cross-validation half, and MOTA / IDF1
    of the in-process tracking eval over MOT17-02-FRCNN's second half),
    resumed with `resume_optim` to a third (the step count goes on), then
    `eval_only` from the saved weights (its AP equals the last
    validation's); the batches fall in the 608x1088 and 800x1344 buckets
    and, where a crop stands upright, in 1088x1920 (`TRAIN_BUCKETS`);
    then the fast mode (`tpu_fast`) one epoch, without the
    tracking eval, so that every window-layer launch is the validation
    pass's (B = 2, 800x1344). Every training step's bucket, the seconds the
    step waited on the `Loader` and the seconds of the step itself, the
    memory allocated after it and the entries of the per-shape caches;
    each validation's seconds a frame; the tracking evals' Hz; peak memory
    and the launches by shape of each run. MOTA and IDF1 of random weights
    are plumbing, not accuracy. Each run's line carries `card`, the
    card's nvidia-smi name and power limit. -> the runs' launch counts by
    run."""
    import contextlib
    import io
    import re

    from trackformer_tpu_torch.cli import train as cli_train
    from trackformer_tpu_torch.engine import loop
    from trackformer_tpu_torch.models.deformable_transformer import \
        _shapes_tensor
    from trackformer_tpu_torch.models.windowed_encoder import _idx_tensor
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.tools import generate_coco_from_mot

    t0 = time.perf_counter()
    write_mot_sequences(tmp, TRAIN_CLI_SEQS, TRAIN_CLI_FRAMES, seed=seed + 2,
                        ext="jpg")
    root = tmp / "MOT17"
    with contextlib.redirect_stdout(io.StringIO()):
        generate_coco_from_mot.main(["mot17", "--data-root", str(root)])
    ann = json.loads((root / "annotations" / "mot17_train_coco.json")
                     .read_text())
    n_train = len(TRAIN_CLI_SEQS) * TRAIN_CLI_FRAMES
    check(len(ann["images"]) == n_train
          and len(ann["annotations"]) == n_train * len(RECTS),
          f"train_cli: the converter wrote {len(ann['images'])} images and "
          f"{len(ann['annotations'])} annotations")
    phase("train_cli", frames=f"{ORIG_HW[0]}x{ORIG_HW[1]} JPEG",
          sequences=f"{len(TRAIN_CLI_SEQS)}x{TRAIN_CLI_FRAMES}",
          write_and_convert_s=f"{time.perf_counter() - t0:.2f}")

    steps, evals = [], []
    caches = (_shapes_tensor, _idx_tensor)
    loader_cls, evaluate, tracking_eval = (cli_train.Loader, loop.evaluate,
                                           loop.tracking_eval)

    class TimedLoader(loader_cls):
        """The CLI's Loader; of the training loader (the shuffled one) each
        batch's wait (the consumer asked, the batch came) and step (the
        consumer had it until it asked again), with the bucket, the memory
        allocated after the step and the caches' entries."""

        def __iter__(self):
            it = super().__iter__()
            if not self.shuffle:
                yield from it
                return
            while True:
                t1 = time.perf_counter()
                try:
                    pack = next(it)
                except StopIteration:
                    return
                t2 = time.perf_counter()
                cached = sum(c.cache_info().currsize for c in caches)
                yield pack
                t3 = time.perf_counter()
                steps[-1].append(dict(
                    bucket=tuple(pack["batch"].images.shape[1:3]),
                    wait=t2 - t1, step=t3 - t2,
                    allocated=torch.cuda.memory_allocated(),
                    built=sum(c.cache_info().currsize for c in caches)
                    - cached))

    def timed_evaluate(*args, **kw):
        t1 = time.perf_counter()
        stats = evaluate(*args, **kw)
        evals[-1]["evaluate_s"].append(time.perf_counter() - t1)
        return stats

    def timed_tracking_eval(*args, **kw):
        t1 = time.perf_counter()
        got = tracking_eval(*args, **kw)
        evals[-1]["tracking_s"].append(time.perf_counter() - t1)
        return got

    base = ["with", "deformable", "tracking", "multi_frame", "dataset=mot",
            f"mot_path_train={root}", f"mot_path_val={root}",
            "train_split=mot17_train_coco",
            "val_split=mot17_train_cross_val_frame_0_5_to_1_0_coco",
            f"tpu.eval_subset={TRAIN_CLI_EVAL_SUBSET}", "val_interval=1",
            f"val_track_dataset={TRAIN_CLI_SEQS[0]}", f"data_root_dir={tmp}",
            "tracking_eval=true"]
    track_frames = TRAIN_CLI_FRAMES - TRAIN_CLI_FRAMES // 2
    val_batches = TRAIN_CLI_EVAL_SUBSET // TRAIN_BATCH
    steps_per_epoch = n_train // TRAIN_BATCH
    counts_by_run = {}

    def run(tag: str, argv: list, want_steps: int):
        steps.append([])
        evals.append({"evaluate_s": [], "tracking_s": []})
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = cli_train.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        counts = counts_by_run[tag] = launch_counts()
        shapes = msda.launch_shapes()
        record_path()
        text = buf.getvalue()
        for line in text.splitlines():
            if line.startswith(("EVAL SUBSET", "RESUME", "tpu.remat",
                                "NUM TRAINABLE", "TRAINING DONE", "EVAL:",
                                "RUNTIME ALL SEQS")) \
                    or re.match(r"Epoch: \[\d+\] step 0 ", line):
                print(f"[{tag}] cli: {line[:400]}", flush=True)
        hz = [float(h) for h in re.findall(
            r"RUNTIME ALL SEQS[^:]*: [\d.]+ s for \d+ frames \(([\d.]+) Hz\)",
            text)]
        ran = steps[-1]
        check(len(ran) == want_steps,
              f"{tag}: {len(ran)} training steps, want {want_steps}")
        ev = evals[-1]
        val_s = [e - t for e, t in zip(ev["evaluate_s"], ev["tracking_s"]
                                       + [0.0] * len(ev["evaluate_s"]))]
        fields = dict(
            card=json.dumps(card), seconds=f"{seconds:.2f}", steps=len(ran),
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            validations=len(ev["evaluate_s"]),
            val_s_per_frame=json.dumps([round(v / TRAIN_CLI_EVAL_SUBSET, 4)
                                        for v in val_s]),
            tracking_eval_s=json.dumps([round(t, 3)
                                        for t in ev["tracking_s"]]),
            tracking_eval_hz=json.dumps(hz),
            launches=nonzero(counts),
            launches_by_shape=json.dumps(
                {f"{k[0]} N={k[1]} Lq={k[2]} levels={list(k[3])}": n
                 for k, n in sorted(shapes.items())},
                separators=(",", ":")))
        if ran:
            share = sum(r["wait"] for r in ran) / sum(
                r["wait"] + r["step"] for r in ran)
            fields.update(
                step_s_median=f"{statistics.median(r['step'] for r in ran):.4f}",
                wait_s_median=f"{statistics.median(r['wait'] for r in ran):.4f}",
                loader_wait_share=f"{share:.3f}",
                buckets=json.dumps({f"{b[0]}x{b[1]}": sum(
                    r["bucket"] == b for r in ran) for b in sorted(
                        {r["bucket"] for r in ran})}))
        phase(tag, **fields)
        return out, counts, hz

    cli_train.Loader = TimedLoader
    loop.evaluate, loop.tracking_eval = timed_evaluate, timed_tracking_eval
    try:
        run_dir = tmp / "run"
        exact = base + [f"output_dir={run_dir}"]
        state, counts, hz = run("train_cli_exact", exact + ["epochs=2"],
                                2 * steps_per_epoch)
        n_steps = 2 * steps_per_epoch
        check(state.step == n_steps,
              f"train_cli_exact: state step {state.step}, want {n_steps}")
        want = {k: REMAT_STEP.get(k, 0) * n_steps + EXACT_FORWARD.get(k, 0)
                * 2 * (val_batches + track_frames) for k in counts}
        check(counts == want, f"train_cli_exact: launches {counts}, want "
                              f"{want}")
        check(len(hz) == 2, f"train_cli_exact: {len(hz)} tracking evals")
        for name in ("config.yaml", "checkpoint.pt", "checkpoint_params.npz",
                     "checkpoint_best_AP.npz", "checkpoint_best_MOTA.npz"):
            check((run_dir / name).exists(), f"train_cli_exact: no {name}")
        # (d): after each bucket's first step no step builds a cache entry,
        # and the memory left after a step does not grow
        ran = steps[0]
        first = {}
        for r in ran:
            first.setdefault(r["bucket"], r)
        rebuilt = sum(r["built"] for r in ran
                      if r is not first[r["bucket"]])
        buckets = {BUCKET} | {b for b, _ in TRAIN_BUCKETS.values()}
        check(TRAIN_BUCKETS["608"][0] in first and BUCKET in first
              and set(first) <= buckets,
              f"train_cli_exact: trained at buckets {sorted(first)}")
        later = [r["allocated"] for r in ran[2:]]
        phase("train_cli_caches", buckets_in_order=json.dumps(
            ["x".join(map(str, r["bucket"])) for r in ran]),
            entries_built_by_each_step=json.dumps([r["built"] for r in ran]),
            allocated_mib_after_each_step=json.dumps(
                [round(r["allocated"] / 2**20, 1) for r in ran]),
            rebuilt_on_a_seen_bucket=rebuilt)
        check(rebuilt == 0, "train_cli_exact: a step built a cache entry on "
                            "a bucket seen before")
        check(max(later) - min(later) <= 64 * 2**20,
              f"train_cli_exact: allocated memory after a step moved by "
              f"{(max(later) - min(later)) / 2**20:.1f} MiB")

        state, counts, _ = run("train_cli_resume", exact + [
            "epochs=3", "resume_optim=true"], steps_per_epoch)
        check(state.step == 3 * steps_per_epoch,
              f"train_cli_resume: state step {state.step}, want "
              f"{3 * steps_per_epoch}")
        check(json.loads((run_dir / "meta.json").read_text())["epoch"] == 3,
              "train_cli_resume: meta.json is not at epoch 3")
        epochs = [json.loads(line) for line in (
            run_dir / "vis" / "epoch_metrics.jsonl").read_text().splitlines()]
        check([e["epoch"] for e in epochs] == [1, 2, 3]
              and all({"AP", "AP50", "MOTA", "IDF1", "loss"} <= set(e)
                      for e in epochs),
              f"train_cli: epoch_metrics {[sorted(e) for e in epochs]}")
        last = epochs[-1]

        stats, counts, _ = run("train_cli_eval_only", base + [
            "eval_only=true", f"resume={run_dir / 'checkpoint_params.npz'}"],
            0)
        losses = [k for k in stats if k.startswith("loss_")]
        rel = max(abs(stats[k] - last[k]) / max(abs(last[k]), 1e-6)
                  for k in losses)
        phase("train_cli_eval_only", ap=stats["AP"], last_val_ap=last["AP"],
              mota=stats["MOTA"], idf1=stats["IDF1"],
              last_val_mota=last["MOTA"], last_val_idf1=last["IDF1"],
              losses_max_rel_diff=f"{rel:.3e}", stats_keys=json.dumps(
                  sorted(stats)), note=json.dumps(
                  "MOTA and IDF1 of random weights: plumbing, not accuracy"))
        check(stats["AP"] == last["AP"],
              f"train_cli_eval_only: AP {stats['AP']}, the last validation's "
              f"{last['AP']}")
        check(rel <= 1e-3, f"train_cli_eval_only: losses {rel:.3e} apart "
                           f"from the last validation's")

        fast_dir = tmp / "run_fast"
        state, counts, _ = run("train_cli_fast", base + [
            "tpu_fast", "epochs=1", "tracking_eval=false",
            f"output_dir={fast_dir}"], steps_per_epoch)
        check(state.step == steps_per_epoch,
              f"train_cli_fast: state step {state.step}")
        want_window = 6 * val_batches
        check(counts["fused_window_layer"] == want_window
              and counts["msda_bwd"] == 6 * steps_per_epoch,
              f"train_cli_fast: launches {nonzero(counts)}")
        phase("train_cli", card=json.dumps(card),
              phase_seconds=f"{time.perf_counter() - t0:.2f}")
    finally:
        cli_train.Loader = loader_cls
        loop.evaluate, loop.tracking_eval = evaluate, tracking_eval
    return counts_by_run


class _Sequence:
    """What `get_mot_accum` reads of a sequence: its frames' ground truth,
    its length and its name."""

    def __init__(self, gts, name: str):
        self.data = [{"gt": gt} for gt in gts]
        self.name = name

    def __len__(self):
        return len(self.data)

    def __str__(self):
        return self.name


class NotRun(dict):
    """The results of a kernel phase that did not run: any case reads as
    empty."""

    def __missing__(self, key):
        return {}


def channel_key(key):
    """A launch shape as the wrappers count it: the gather kernel's and the
    backward's with the channels of a head (`D` where the key has none)."""
    if key[0] in ("msda_patch", "ms_deform_attn", "msda_bwd") \
            and len(key) == 4:
        return key + (D,)
    return key


# --------------------------------------------------------------------------
# the single-frame Deformable DETR family and the other model switches
# --------------------------------------------------------------------------

# launches per frame of the single-frame exact model (6 encoder layers
# over one frame, 6 decoder layers) and per train step of the exact
# single-frame and joint-encoder models (the previous frame's forward
# without gradient): tracking and detection
SINGLE_PER_FRAME = {"msda_patch": 6, "ms_deform_attn": 6}
SINGLE_STEP = {True: {"msda_patch": 12, "ms_deform_attn": 12,
                      "msda_bwd": 12},
               False: {"msda_patch": 6, "ms_deform_attn": 6, "msda_bwd": 12}}
# the windowed models train their encoder on its module path: the decoder
# alone launches
FAST_STEP = {True: {"ms_deform_attn": 12, "msda_bwd": 6},
             False: {"ms_deform_attn": 6, "msda_bwd": 6}}
# the train CLI's square bucket (`cli.train.image_buckets`), with an
# upright crop of 1333 x 750 in it
SQUARE_BUCKET, SQUARE_VALID = (1344, 1344), (1333, 750)


def variant_config(named, **changes):
    """`FlagshipConfig` of `train.yaml` + `named` (a 20-class head, the
    tracker of `cfgs/track.yaml`), its train steps without `tpu.remat`
    unless `changes` turn it on (the `train_extras` phase measures
    it)."""
    from trackformer_tpu_torch.utils.config import (FlagshipConfig,
                                                    load_config)
    cfg = FlagshipConfig.from_config(load_config(
        "train.yaml", named, {"dataset": "mot_crowdhuman"}))
    return cfg.replace(**{"remat": False, **changes})


def variant_train_steps(tag: str, cfg, seed: int, steps, want,
                        hw=BUCKET, valid=VALID_HW):
    """Train steps of `cfg`'s model with seeded weights at B = 2 on the
    drifting texture with boxes (`synthetic_train_pack`): `steps` a list
    of `tracking` flags, each step's launches against `want[tracking]`,
    finite losses, a nonzero gradient; the launches go into
    `NEW_SHAPES` -> (the model after the steps, in training mode, the last
    loss)."""
    from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                              make_train_step)
    from trackformer_tpu_torch.models import build_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model, crit_cfg, _, track_cfg = build_model(cfg, "cuda", generator=gen,
                                                train=True)
    optimizer = make_optimizer(cfg, model)
    state = TrainState.create(model, optimizer)
    fns = {flag: make_train_step(model, crit_cfg, optimizer, track_cfg,
                                 tracking=flag) for flag in set(steps)}
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for step, tracking in enumerate(steps):
        pack = synthetic_train_pack(cfg, seed, step, hw, valid)
        if not tracking:
            pack = {"batch": pack["batch"], "targets": pack["targets"]}
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = fns[tracking](state, pack, gen)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in launch_counts().items() if v}
        record_new_path(tag)
        phase(tag, step=step, tracking=tracking,
              image="x".join(map(str, hw)), batch=TRAIN_BATCH,
              loss=f"{loss:.4f}", grad_norm=f"{norm:.4f}",
              step_ms=f"{step_ms:.1f}",
              peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
              launches=json.dumps(counts, separators=(",", ":")))
        check(np.isfinite(loss) and np.isfinite(norm) and norm > 0,
              f"{tag} step {step}: loss {loss}, grad_norm {norm}")
        check(counts == want[tracking],
              f"{tag} step {step}: launches {counts}, want "
              f"{want[tracking]}")
        losses.append(loss)
    return model, losses


def variants_run(seed: int, n_frames: int) -> dict:
    """The single-frame Deformable DETR family at full width (`train.yaml`
    + `deformable tracking`: hidden 256, 8 heads of 32, 6+6 layers, FFN
    1024, 300 queries, 4 levels, box refinement, bf16), exact and with
    `tpu_fast` (the windowed encoder over the frame, kernel #8 at C = 256):
    `Tracker` over `n_frames` 800x1344 frames, train steps at B = 2
    (tracking twice, then detection), for the fast model an eval forward
    of a training batch (B = 2), and one float32 forward card against CPU.
    Then the flagship with one encoder over both frames' 8 levels
    (`multi_frame_attention_separate_encoder: false`): a 3-frame `Tracker`
    and one train step; and the exact flagship's train step in the train
    CLI's 1344x1344 bucket (an upright crop). Every MSDA launch shape goes
    into `NEW_SHAPES` -> the launches of the runs by tag."""
    single = ["deformable", "tracking"]
    exact = variant_config(single)
    fast = variant_config(single + ["tpu_fast"])
    check((exact.hidden_dim, exact.nheads, exact.num_queries,
           exact.multi_frame_attention, exact.with_box_refine,
           exact.compute_dtype) == (256, 8, 300, False, True, "bfloat16")
          and fast.encoder_attention == "windowed",
          f"variants: configs {exact} / {fast}")
    out = {}
    for tag, cfg, per_frame, per_step in (
            ("variant_exact", exact, SINGLE_PER_FRAME, SINGLE_STEP),
            ("variant_fast", fast, FAST_PER_FRAME, FAST_STEP)):
        model, post = smoke_model(cfg, seed, tag)
        counts, _ = tracker_run(tag, cfg, model, post, n_frames, seed,
                                per_frame)
        note_new_shapes(tag)
        out[tag] = counts
        reference_run(tag, model, 1)
        del model
        trained, losses = variant_train_steps(f"{tag}_train", cfg, seed,
                                              [True, True, False], per_step)
        if tag == "variant_fast":
            # an eval forward of a training batch: kernel #8 at B = 2
            trained.eval()
            pack = synthetic_train_pack(cfg, seed, 0)
            reset_launch_counts()
            with torch.no_grad():
                res = trained(pack["batch"])[0]
            counts = launch_counts()
            record_new_path(tag)
            out[f"{tag}_eval_b2"] = counts
            check(bool(torch.isfinite(res["pred_boxes"]).all()),
                  f"{tag}: non-finite eval forward")
            for name, n in counts.items():
                check(n == FAST_PER_FRAME.get(name, 0),
                      f"{tag} eval B = 2: {n} {name} launches")
            phase(tag, eval_forward="B = 2, 800x1344",
                  launches=json.dumps({k: v for k, v in counts.items() if v},
                                      separators=(",", ":")))
        del trained
    joint = variant_config(["deformable", "tracking", "multi_frame"],
                           multi_frame_attention_separate_encoder=False)
    model, post = smoke_model(joint, seed, "variant_joint")
    out["variant_joint"], _ = tracker_run("variant_joint", joint, model,
                                          post, 3, seed, SINGLE_PER_FRAME)
    note_new_shapes("variant_joint")
    del model
    variant_train_steps("variant_joint_train", joint, seed, [True],
                        SINGLE_STEP)
    flagship = variant_config(["deformable", "tracking", "multi_frame"])
    variant_train_steps(
        "variant_square_bucket", flagship, seed, [True],
        {True: {"msda_patch": 24, "ms_deform_attn": 12, "msda_bwd": 18}},
        SQUARE_BUCKET, SQUARE_VALID)
    return out


# steps of each arm in the agreement phase: the detection task at the
# flagship scale (bf16, 416x544, B = 4) and the tracking task at the mid
# scale (float32, 192x256, B = 4)
# (30 and 50 steps before the panoptic and train_extras phases came: cut
# to keep the whole run near its time)
AGREE_DET_STEPS, AGREE_TRACK_STEPS = 10, 25


def falls(losses) -> bool:
    """The mean of the last five losses below that of the first five."""
    return float(np.mean(losses[-5:])) < float(np.mean(losses[:5]))


def agreement_run(seed: int) -> dict:
    """The port's agreement tools on the card, briefly: each arm of the
    detection task (`fast_exact_agreement`, `flagship` scale) trained
    `AGREE_DET_STEPS` steps and scored (mAP, AP50, cross-agreement), each
    arm of the tracking task (`tracking_agreement`, `mid` scale)
    `AGREE_TRACK_STEPS` steps, tracked and scored (MOTA, IDF1, cross);
    checks that every arm's loss falls and that the scores are numbers.
    The launches of each run go into `NEW_SHAPES` -> launches by run."""
    from trackformer_tpu_torch.tools import fast_exact_agreement as det
    from trackformer_tpu_torch.tools import tracking_agreement as trk

    def log(msg):
        print(f"[agreement] {msg}", flush=True)

    out = {}
    sc = det.SCALES["flagship"]
    train, held_out = det.make_scenes(sc)
    gt = det.boxes_to_anns(held_out)
    preds = {}
    for mode in ("exact", "fast"):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        preds[mode], losses = det.train_and_eval(
            mode, train, held_out, sc, AGREE_DET_STEPS, "cuda", None, seed,
            log=log)
        seconds = time.perf_counter() - t0
        out[f"det_{mode}"] = launch_counts()
        record_new_path(f"agreement_det_{mode}")
        ap, ap50 = det.eval_map(preds[mode], gt, sc)
        phase("agreement", task="detection", scale=sc.name, mode=mode,
              steps=len(losses), seconds=f"{seconds:.1f}",
              first_loss=f"{np.mean(losses[:5]):.4f}",
              last_loss=f"{np.mean(losses[-5:]):.4f}", map=f"{ap:.4f}",
              ap50=f"{ap50:.4f}", launches=json.dumps(
                  {k: v for k, v in out[f"det_{mode}"].items() if v},
                  separators=(",", ":")))
        check(len(losses) == AGREE_DET_STEPS and falls(losses),
              f"agreement detection {mode}: losses {losses}")
        check(np.isfinite(ap) and np.isfinite(ap50),
              f"agreement detection {mode}: mAP {ap}, AP50 {ap50}")
    cross = det.eval_map(preds["fast"], det.preds_to_anns(preds["exact"]),
                         sc)
    phase("agreement", task="detection", cross_agreement_map=cross[0],
          cross_agreement_ap50=cross[1])
    check(all(isinstance(v, float) for v in cross),
          f"agreement: cross agreement {cross}")
    check(out["det_fast"]["fused_window_layer"]
          == 6 * -(-sc.n_eval // sc.batch),
          f"agreement: {out['det_fast']['fused_window_layer']} window layer "
          f"calls in the fast arm's eval")

    tsc = trk.SCALES["mid"]
    train_seqs, eval_seqs = trk.make_sequences(tsc)
    gts = [s[1] for s in eval_seqs]
    results = {}
    for mode in ("exact", "fast"):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        model, post, model_cfg, losses = trk.train_arm(
            mode, train_seqs, tsc, AGREE_TRACK_STEPS, "cuda", None, seed,
            log)
        results[mode] = trk.run_tracker(model, post, model_cfg, eval_seqs,
                                        tsc, "cuda")
        seconds = time.perf_counter() - t0
        out[f"track_{mode}"] = launch_counts()
        record_new_path(f"agreement_track_{mode}")
        mota, idf1 = trk.score(results[mode], gts, mode)
        phase("agreement", task="tracking", scale=tsc.name, mode=mode,
              steps=len(losses), seconds=f"{seconds:.1f}",
              first_loss=f"{np.mean(losses[:5]):.4f}",
              last_loss=f"{np.mean(losses[-5:]):.4f}", mota=f"{mota:.4f}",
              idf1=f"{idf1:.4f}", launches=json.dumps(
                  {k: v for k, v in out[f"track_{mode}"].items() if v},
                  separators=(",", ":")))
        check(len(losses) == AGREE_TRACK_STEPS and falls(losses),
              f"agreement tracking {mode}: losses {losses}")
        check(np.isfinite(mota) and np.isfinite(idf1),
              f"agreement tracking {mode}: MOTA {mota}, IDF1 {idf1}")
        del model
    cross = trk.score(results["fast"],
                      trk.results_as_gts(results["exact"], tsc.t), "cross")
    phase("agreement", task="tracking", cross_mota=cross[0],
          cross_idf1=cross[1])
    frames = tsc.n_eval_seq * tsc.t
    check(out["track_fast"]["window_layer_f32"] == 4 * frames,
          f"agreement: {out['track_fast']['window_layer_f32']} float32 "
          f"window layer launches in the fast arm's {frames} frames")
    return out


# --------------------------------------------------------------------------
# the MOTS20 recipe: vanilla DETR with masks, and the Deformable DETR masks
# model
# --------------------------------------------------------------------------

MASKS_SEQS = ("MOTS20-02", "MOTS20-05")
MASKS_FRAMES = 4               # 1080x1920 frames of each synthetic sequence
MASKS_EVAL_SUBSET = 2          # frames of the train CLI's mask evaluation


def recipe_config():
    """`FlagshipConfig` of `train.yaml` + `mots20`, the MOTS20 recipe's
    model (cfgs/track.yaml's tracker)."""
    from trackformer_tpu_torch.utils.config import (FlagshipConfig,
                                                    load_config)
    return FlagshipConfig.from_config(load_config("train.yaml", ["mots20"]))


def masks_step_split(cfg, seed: int, reps: int = 3) -> dict:
    """A detection train step of the recipe model at B = 2 (800x1344, box
    masks as targets) split by hand: the forward, the criterion (with
    `loss_mask` / `loss_dice` on (2, 100, 800, 1344) targets) and the
    backward, each timed with a synchronize around it, median of `reps`;
    then the port's `make_train_step` on the same pack: its ms and the
    peak memory."""
    from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                              make_train_step)
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.models.criterion import compute_losses

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model, crit, _, track = build_model(cfg, "cuda", generator=gen,
                                        train=True)
    pack = synthetic_train_pack(cfg, seed, 0)
    pack = {"batch": pack["batch"], "targets": pack["targets"]}
    check(pack["targets"].masks is not None
          and tuple(pack["targets"].masks.shape[-2:]) == BUCKET,
          "masks: the train pack carries no bucket-sized masks")
    split = {"forward": [], "criterion": [], "backward": []}
    losses = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, targets, _, _, _ = model(pack["batch"], pack["targets"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses = compute_losses(out, targets, crit)
        loss = sum(losses[k] * w for k, w in crit.weight_dict.items()
                   if k in losses)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k].append(v * 1e3)
        del out, targets, loss
    losses = {k: v.detach() for k, v in losses.items()}
    check(all(bool(torch.isfinite(losses[k])) and float(losses[k]) > 0
              for k in ("loss_mask", "loss_dice")),
          f"masks: mask losses {losses['loss_mask']}, {losses['loss_dice']}")
    optimizer = make_optimizer(cfg, model)
    state = TrainState.create(model, optimizer)
    step = make_train_step(model, crit, optimizer, track, tracking=False)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, pack, gen)
        float(metrics["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(metrics["loss"])),
          f"masks: train step loss {metrics['loss']}")
    return {**{f"{k}_ms": f"{statistics.median(v):.2f}"
               for k, v in split.items()},
            "step_ms": f"{statistics.median(step_ms):.2f}",
            "step_peak_gib": f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            "loss_mask": f"{float(losses['loss_mask']):.4f}",
            "loss_dice": f"{float(losses['loss_dice']):.4f}"}


def mask_head_share(model, reps: int = 10) -> dict:
    """The eval forward of a mask model at B = 1 (800x1344) with and
    without its mask heads (the detector's own forward): ms each and the
    heads' share."""
    from trackformer_tpu_torch.models.deformable_detr import DeformableDETR
    from trackformer_tpu_torch.models.detr import DETR

    batch = frame_blobs(1, 0)[0]["batch"]
    detector = DETR if isinstance(model, DETR) else DeformableDETR
    with torch.inference_mode():
        full = time_ms(lambda: model(batch), reps)
        base = time_ms(lambda: detector.forward(model, batch), reps)
    return {"forward_ms": f"{full:.2f}", "detector_ms": f"{base:.2f}",
            "mask_head_share": f"{1 - base / full:.3f}"}


def masks_run(seed: int, n_frames: int, tmp: Path, card: str) -> dict:
    """The MOTS20 recipe and the Deformable DETR masks model on the card,
    each line with `card`, the card's nvidia-smi name and power limit:
      (a) the recipe's model (`train.yaml` + `mots20`: DETR, R50 FrozenBN,
          hidden 256, 8 heads, 6 + 6 layers, FFN 2048, 100 queries, 21
          softmax logits, aux loss, the mask heads, bf16) with seeded
          weights: its forward with and without the mask heads;
          `Tracker` over `n_frames` 800x1344 frames with masks (no
          kernel launch); a synthetic MOTS20 layout (`MASKS_SEQS`,
          `MASKS_FRAMES` 1080x1920 JPEGs each, the ground truth as MOTS
          lines); `cli.track` over it
          (150 track slots, 768x1344 frames) with `Tracker` and with
          `BatchedTracker` (`tpu.batch_sequences=2`), its MOTS result
          files read back through `load_results`, its box metrics, Hz
          and the host's read + preprocess ms a frame; the layout
          converted by `generate_coco_from_mot` in MOTS mode; `cli.train
          with mots20` one epoch at B = 2 with a mask evaluation, then
          `eval_only` from its checkpoint (box and mask AP); a train step
          at B = 2 split into forward, criterion and backward, with its
          peak memory;
      (b) `DeformableDETRSegm` (`deformable tracking`, `masks: true`:
          hidden 256, 300 queries, 4 levels, box refinement, bf16):
          `Tracker` over `n_frames` 800x1344 frames with masks (6
          `msda_patch` and 6 `ms_deform_attn` launches a frame), its
          forward with and without the mask heads, 2 train steps at B = 2
          (track queries, with the backward's launches);
      (c) each model's float32 forward, card against CPU, on
          `pred_masks`, `pred_logits` and `pred_boxes`.
    MOTA, IDF1 and AP of random weights are plumbing, not accuracy. ->
    the launches of the runs by tag."""
    import contextlib
    import io
    import re
    from types import SimpleNamespace

    from trackformer_tpu_torch.cli import train as cli_train
    from trackformer_tpu_torch.datasets.image_io import read_frame
    from trackformer_tpu_torch.datasets.tracking import TrackDatasetFactory
    from trackformer_tpu_torch.datasets.tracking.mot17_sequence import (
        eval_resize, preprocess_frame)
    from trackformer_tpu_torch.tools import generate_coco_from_mot

    out = {}
    cfg = recipe_config()
    check((cfg.deformable, cfg.masks, cfg.focal_loss, cfg.hidden_dim,
           cfg.nheads, cfg.enc_layers, cfg.dec_layers, cfg.dim_feedforward,
           cfg.num_queries, cfg.dataset, cfg.aux_loss, cfg.compute_dtype)
          == (False, True, False, 256, 8, 6, 6, 2048, 100, "mot", True,
              "bfloat16"), f"masks: the recipe's config {cfg}")
    t0 = time.perf_counter()
    write_mot_sequences(tmp, MASKS_SEQS, MASKS_FRAMES, seed=seed + 3,
                        ext="jpg", mots=True)
    root = tmp / "MOTS20"
    phase("masks_recipe", card=json.dumps(card),
          frames=f"{ORIG_HW[0]}x{ORIG_HW[1]} JPEG",
          sequences=f"{len(MASKS_SEQS)}x{MASKS_FRAMES}",
          write_s=f"{time.perf_counter() - t0:.2f}")
    model, post, ckpt = cli_checkpoint(cfg, ["mots20"], seed,
                                       "masks_recipe", tmp)
    check(type(model).__name__ == "DETRSegm"
          and model.class_embed.out_features == 21,
          f"masks: built {type(model).__name__}")
    phase("masks_recipe", card=json.dumps(card), **mask_head_share(model))
    out["masks_recipe"], results = tracker_run(
        "masks_recipe", cfg, model, post, n_frames, seed, {})
    shapes = {e["mask"].shape for v in results.values() for e in v.values()}
    check(shapes == {(BUCKET[0] // 4, BUCKET[1] // 4)},
          f"masks_recipe: tracker masks of shapes {shapes}")
    reference_run("masks_recipe", model, 1,
                  ("pred_masks", "pred_logits", "pred_boxes"))
    del model

    # (a) the serving entry point over the MOTS20 layout, both trackers
    dataset = TrackDatasetFactory(
        list(MASKS_SEQS), root_dir=str(tmp),
        img_transform=SimpleNamespace(val_width=cfg.val_width,
                                      max_size=cfg.max_size))
    n_frames_cli = len(MASKS_SEQS) * MASKS_FRAMES
    for tag, extra in (("masks_track_cli", []),
                       ("masks_track_cli_b2", ["tpu.batch_sequences=2"])):
        res_dir = tmp / tag
        reset_launch_counts()
        summary, runtime = cli_main(tag, track_argv(
            MASKS_SEQS, tmp, ckpt, f"output_dir={res_dir}", *extra))
        counts = out[tag] = launch_counts()
        record_path()
        check(not any(counts.values()),
              f"{tag}: vanilla DETR launched {nonzero(counts)}")
        check(runtime is not None and runtime[1] == n_frames_cli,
              f"{tag}: runtime line {runtime}")
        rows, tracks, shapes = 0, 0, set()
        for seq in dataset:
            loaded = seq.load_results(str(res_dir))
            tracks += len(loaded)
            for v in loaded.values():
                for e in v.values():
                    rows += 1
                    shapes.add(e["mask"].shape)
                    check(np.isfinite(e["bbox"]).all(),
                          f"{tag}: non-finite box read back")
        check(rows > 0 and shapes == {ORIG_HW},
              f"{tag}: {rows} MOTS rows of shapes {shapes}")
        overall = (summary or {}).get("OVERALL", {})
        phase(tag, card=json.dumps(card), batch=1 if not extra else 2,
              frames=runtime[1], image=f"{CLI_BUCKET[0]}x{CLI_BUCKET[1]}",
              cli_hz=runtime[2], cli_hz_per_sequence=runtime[3],
              mots_rows=rows, tracks=tracks,
              mota=overall.get("mota"), idf1=overall.get("idf1"),
              note=json.dumps("box metrics of random weights: plumbing"))
        check("mota" in overall, f"{tag}: no MOT summary")
    blobs = [seq[i] for seq in dataset for i in range(len(seq))]
    check(all(tuple(b["batch"].images.shape[1:3]) == CLI_BUCKET
              for b in blobs), "masks: a frame is not padded to 768x1344")
    resize = eval_resize(SimpleNamespace(val_width=cfg.val_width,
                                         max_size=cfg.max_size))
    read_ms, pre_ms = [], []
    for seq in dataset:
        for d in seq.data:
            t1 = time.perf_counter()
            img = read_frame(d["im_path"])
            t2 = time.perf_counter()
            preprocess_frame(img, resize)
            read_ms.append((t2 - t1) * 1e3)
            pre_ms.append((time.perf_counter() - t2) * 1e3)
    phase("masks_track_cli", card=json.dumps(card),
          read_frame_ms=f"{statistics.median(read_ms):.2f}",
          preprocess_frame_ms=f"{statistics.median(pre_ms):.2f}")

    # (a) the training entry point: the converter in MOTS mode, one epoch
    # with a mask evaluation, then `eval_only` from its checkpoint
    with contextlib.redirect_stdout(io.StringIO()):
        generate_coco_from_mot.main(["mots20", "--data-root", str(root)])
    ann = json.loads((root / "annotations" / "mots20_train_coco.json")
                     .read_text())
    n_train = len(MASKS_SEQS) * MASKS_FRAMES
    check(len(ann["images"]) == n_train
          and len(ann["annotations"]) == n_train * len(RECTS)
          and all(isinstance(a["segmentation"], dict)
                  for a in ann["annotations"]),
          f"masks: the converter wrote {len(ann['images'])} images and "
          f"{len(ann['annotations'])} mask annotations")
    run_dir = tmp / "masks_run"
    base = ["with", "mots20", f"mot_path_train={root}",
            f"mot_path_val={root}", f"tpu.eval_subset={MASKS_EVAL_SUBSET}"]
    for tag, argv in (
            ("masks_train_cli", base + ["epochs=1",
                                        f"output_dir={run_dir}"]),
            ("masks_train_cli_eval_only", base + [
                "eval_only=true",
                f"resume={run_dir / 'checkpoint_params.npz'}"])):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = cli_train.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        counts = out[tag] = launch_counts()
        record_path()
        for line in buf.getvalue().splitlines():
            if line.startswith(("EVAL", "RESUME", "NUM TRAINABLE",
                                "TRAINING DONE")) \
                    or re.match(r"Epoch: \[\d+\] step \d+ ", line):
                print(f"[{tag}] cli: {line[:300]}", flush=True)
        check(not any(counts.values()),
              f"{tag}: vanilla DETR launched {nonzero(counts)}")
        fields = dict(card=json.dumps(card), seconds=f"{seconds:.2f}",
                      peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        if tag == "masks_train_cli":
            want = n_train // TRAIN_BATCH
            check(result.step == want,
                  f"{tag}: {result.step} steps, want {want}")
            epochs = [json.loads(line) for line in (
                run_dir / "vis" / "epoch_metrics.jsonl").read_text()
                .splitlines()]
            fields.update(steps=result.step, last_epoch=json.dumps(
                {k: v for k, v in epochs[-1].items()
                 if k in ("loss", "loss_mask", "loss_dice", "AP")}))
        else:
            check({"AP", "AP_masks", "coco_eval_masks"} <= set(result)
                  and len(result["coco_eval_masks"]) == 12,
                  f"{tag}: stats {sorted(result)}")
            fields.update(ap=result["AP"], ap_masks=result["AP_masks"],
                          loss_mask=f"{result['loss_mask']:.4f}",
                          loss_dice=f"{result['loss_dice']:.4f}")
        phase(tag, **fields)
    phase("masks_train_step", card=json.dumps(card), batch=TRAIN_BATCH,
          image=f"{BUCKET[0]}x{BUCKET[1]}",
          **masks_step_split(cfg, seed, reps=2))

    # (b) the Deformable DETR masks model: tracker, train steps, forward
    dcfg = variant_config(["deformable", "tracking"], masks=True)
    check((dcfg.hidden_dim, dcfg.num_queries, dcfg.num_feature_levels,
           dcfg.with_box_refine, dcfg.masks, dcfg.multi_frame_attention)
          == (256, 300, 4, True, True, False),
          f"masks: the deformable masks config {dcfg}")
    model, dpost = smoke_model(dcfg, seed, "masks_deformable")
    out["masks_deformable"], results = tracker_run(
        "masks_deformable", dcfg, model, dpost, n_frames, seed,
        SINGLE_PER_FRAME)
    note_new_shapes("masks_deformable")
    shapes = {e["mask"].shape for v in results.values() for e in v.values()}
    check(shapes == {(BUCKET[0] // 4, BUCKET[1] // 4)},
          f"masks_deformable: tracker masks of shapes {shapes}")
    phase("masks_deformable", card=json.dumps(card),
          **mask_head_share(model))
    reference_run("masks_deformable", model, 1,
                  ("pred_masks", "pred_logits", "pred_boxes"))
    del model
    torch.cuda.reset_peak_memory_stats()
    variant_train_steps("masks_deformable_train", dcfg, seed, [True, True],
                        SINGLE_STEP)
    phase("masks_deformable_train", card=json.dumps(card),
          peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return out


# --------------------------------------------------------------------------
# the rest of the Deformable DETR family: two-stage, the dense decoder,
# merged frame features, the exact cached memory, other level counts with
# ResNet-101 and DC5, and the fast flagship at window side 16
# --------------------------------------------------------------------------

# launches per frame of the exact multi-frame flagship's variants: the
# dense decoder launches no decoder MSDA; the cached memory encodes one
# frame (6 encoder launches, not 12)
DENSE_PER_FRAME = {"msda_patch": 12}
CACHED_EXACT_PER_FRAME = {"msda_patch": 6, "ms_deform_attn": 6}
# a train step of the flagship with the dense decoder: both frames'
# encoders (12 each), the current frame's encoder backward (12)
DENSE_STEP = {True: {"msda_patch": 24, "msda_bwd": 12}}
MERGE_STEP = {True: EXACT_STEP}
# two-stage: `train.yaml` + `deformable` (single frame, no track queries)
TWO_STAGE_STEP = {False: SINGLE_STEP[False]}
# steps of the window-16 agreement arm (detection, the flagship scale)
AGREE_W16_STEPS = 4


def two_stage_match_split(model, cfg, seed: int, reps: int = 3) -> dict:
    """The two-stage criterion at B = 2 on a training batch of the trained
    `cfg` model: ms of `compute_losses` with and without the proposals'
    `_enc` losses, and of the encoder match alone (22,323 proposals an
    image against its targets, `hungarian_batched` on the host), medians
    of `reps` after a warm-up."""
    from trackformer_tpu_torch.models.criterion import compute_losses
    from trackformer_tpu_torch.models.factory import train_configs
    from trackformer_tpu_torch.models.matcher import match

    crit_cfg = train_configs(cfg)[0]
    pack = synthetic_train_pack(cfg, seed, 0)
    targets = pack["targets"]
    with torch.no_grad():
        out = model(pack["batch"])[0]
    enc = dict(out["enc_outputs"])
    enc["query_valid"] = torch.ones(enc["pred_logits"].shape[:2],
                                    dtype=torch.bool, device="cuda")
    binary = targets.replace(labels=torch.zeros_like(targets.labels))
    plain = {k: v for k, v in out.items() if k != "enc_outputs"}

    def ms(fn):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    with torch.no_grad():
        split = {"criterion_ms": ms(lambda: compute_losses(out, targets,
                                                          crit_cfg)),
                 "criterion_without_enc_ms": ms(lambda: compute_losses(
                     plain, targets, crit_cfg)),
                 "encoder_match_ms": ms(lambda: match(enc, binary,
                                                      crit_cfg.matcher))}
        losses = compute_losses(out, targets, crit_cfg)
    check(all(bool(torch.isfinite(v).all()) for v in losses.values()),
          "two_stage: non-finite criterion")
    return dict(split, proposals=enc["pred_logits"].shape[1],
                enc_losses=sorted(k for k in losses if k.endswith("_enc")))


def family_run(seed: int, n_frames: int) -> dict:
    """The rest of the Deformable DETR family at full width with seeded
    weights, bf16, 800x1344 (module docstring, `family`) -> the launches of
    the runs by tag. Every MSDA launch shape goes into `NEW_SHAPES`."""
    from trackformer_tpu_torch.structures import FrameBatch
    from trackformer_tpu_torch.tools import fast_exact_agreement as det
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    out = {}
    # two-stage: a forward, 2 detection steps at B = 2 with the `_enc`
    # losses, the criterion's split, `evaluate` on 2 frames, float32
    # card vs CPU forward and train step
    two = variant_config(["deformable"], two_stage=True)
    check((two.hidden_dim, two.num_queries, two.num_feature_levels,
           two.with_box_refine, two.two_stage, two.tracking) ==
          (256, 300, 4, True, True, False), f"two_stage: config {two}")
    model, post = smoke_model(two, seed, "two_stage")
    blob = frame_blobs(1, seed)[0]
    batch = FrameBatch(images=blob["batch"].images,
                       mask=blob["batch"].mask.cuda())
    with torch.no_grad():
        model(batch)            # warm-up: first calls, cuBLAS plans
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = model(batch)[0]
        torch.cuda.synchronize()
    counts = launch_counts()
    record_new_path("two_stage")
    out["two_stage"] = counts
    phase("two_stage", forward_ms=f"{(time.perf_counter() - t0) * 1e3:.1f}",
          queries=res["pred_logits"].shape[1],
          proposals=res["enc_outputs"]["pred_logits"].shape[1],
          launches=json.dumps({k: v for k, v in counts.items() if v},
                              separators=(",", ":")))
    check(all(bool(torch.isfinite(res[k]).all())
              for k in ("pred_logits", "pred_boxes"))
          and res["pred_logits"].shape[1] == two.num_queries,
          "two_stage: forward outputs")
    check({k: v for k, v in counts.items() if v} == SINGLE_PER_FRAME,
          f"two_stage: forward launches {counts}")
    reference_run("two_stage", model, 1)
    del model
    trained, losses = variant_train_steps("two_stage_train", two, seed,
                                          [False, False], TWO_STAGE_STEP)
    split = two_stage_match_split(trained, two, seed)
    phase("two_stage_criterion", batch=TRAIN_BATCH,
          **{k: (f"{v:.1f}" if isinstance(v, float) else v)
             for k, v in split.items()})
    del trained
    evaluate_run(two, seed, "two_stage", SINGLE_PER_FRAME, n_frames=2,
                 track=False)
    train_reference_run(seed, base=two, label="two_stage_reference",
                        tracking=False, own_share=True)

    flagship = ["deformable", "tracking", "multi_frame"]
    # the dense decoder (peak memory of its Tracker and train steps), merged
    # frame features, the exact encoder over the cached memory
    for tag, change, per_frame, frames, steps, per_step in (
            ("dense_decoder", dict(decoder_attention="dense"),
             DENSE_PER_FRAME, n_frames, [True, True], DENSE_STEP),
            ("merge_frame_features", dict(merge_frame_features=True),
             {"msda_patch": 12, "ms_deform_attn": 6}, n_frames, [True],
             MERGE_STEP),
            ("msda_cached_memory", dict(cached_prev_memory=True),
             CACHED_EXACT_PER_FRAME, n_frames, [], None)):
        cfg = variant_config(flagship, **change)
        model, post = smoke_model(cfg, seed, tag)
        torch.cuda.reset_peak_memory_stats()
        out[tag], _ = tracker_run(tag, cfg, model, post, frames, seed,
                                  per_frame)
        note_new_shapes(tag)
        phase(tag, tracker_peak_memory_gib=(
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f}"))
        del model
        if steps:
            variant_train_steps(f"{tag}_train", cfg, seed, steps, per_step)
    # other level counts: ResNet-101 with 5 levels, and DC5 (C5 at stride
    # 16: the last two backbone levels of one shape)
    for tag, change in (("resnet101_5_levels", dict(backbone="resnet101",
                                                    num_feature_levels=5)),
                        ("dc5", dict(dilation=True))):
        cfg = variant_config(["deformable", "tracking"], **change)
        model, post = smoke_model(cfg, seed, tag)
        out[tag], _ = tracker_run(tag, cfg, model, post, 3, seed,
                                  SINGLE_PER_FRAME)
        note_new_shapes(tag)
        del model
        variant_train_steps(f"{tag}_train", cfg, seed, [True], SINGLE_STEP)

    # the fast flagship at window side 16: `Tracker`, `BatchedTracker` of 8
    # sequences x 3 frames, and the agreement tool's `fast_w16` arm
    w16 = FlagshipConfig.tpu_fast(dataset="mot_crowdhuman").replace(
        encoder_window=16)
    model, post = smoke_model(w16, seed, "fast_w16")
    out["fast_w16"], _ = tracker_run("fast_w16", w16, model, post, n_frames,
                                     seed, FAST_PER_FRAME)
    out["fast_w16_batched"] = batched_run(w16, model, post, 8, 3, seed,
                                          tag="fast_w16_batched")
    reference_run("fast_w16", model, 2)
    del model
    sc = det.SCALES["flagship"]
    train, held_out = det.make_scenes(sc)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    preds, losses = det.train_and_eval(
        "fast_w16", train, held_out, sc, AGREE_W16_STEPS, "cuda", None, seed,
        log=lambda msg: print(f"[family] {msg}", flush=True))
    out["agree_fast_w16"] = launch_counts()
    record_new_path("agreement_det_fast_w16")
    ap, ap50 = det.eval_map(preds, det.boxes_to_anns(held_out), sc)
    phase("fast_w16_agreement", scale=sc.name, steps=len(losses),
          seconds=f"{time.perf_counter() - t0:.1f}",
          first_loss=f"{np.mean(losses[:3]):.4f}",
          last_loss=f"{np.mean(losses[-3:]):.4f}", map=f"{ap:.4f}",
          ap50=f"{ap50:.4f}", launches=json.dumps(
              {k: v for k, v in out["agree_fast_w16"].items() if v},
              separators=(",", ":")))
    check(len(losses) == AGREE_W16_STEPS and np.isfinite(losses).all()
          and np.isfinite(ap), f"fast_w16 agreement: {losses}, {ap}")
    check(out["agree_fast_w16"]["fused_window_layer"]
          == 6 * -(-sc.n_eval // sc.batch),
          f"fast_w16 agreement: {out['agree_fast_w16']} window calls")
    return out


# --------------------------------------------------------------------------
# the last model and training options: COCO panoptic, vanilla DETR's
# attention maps with the tracker's soft reset, three-frame training with
# and without backprop through the previous frames, and `tpu.remat`
# --------------------------------------------------------------------------

PAN_HW = BUCKET                # 800x1344 images of the synthetic root
PAN_IMAGES = 2                 # one batch of the evaluation
# the three frames' launches of a three-frame step of the exact flagship:
# each forward encodes two frames (12 `msda_patch`) and decodes (6
# `ms_deform_attn`); the backward runs through the current frame only (12
# encoder + 6 decoder calls), or with `backprop_prev_frame` through all
# three forwards
THREE_STEP = {"msda_patch": 36, "ms_deform_attn": 18, "msda_bwd": 18}
THREE_BACKPROP_STEP = {**THREE_STEP, "msda_bwd": 54}
# the previous frame's decoder with the previous-previous frame's track
# queries: `max_objects` slots (no false positives) + 500 queries
TRAIN_PREV_TRACK_QUERIES = 600
# a remat step against the same step without it: the loss equal (the
# forward is deterministic and the dropout masks replayed); the gradients
# apart by `msda_bwd`'s float32 atomics alone, as two replays of one step
# are (ROADMAP Queue 3: grad_norm 4.4e-6 to 7.6e-6 relative, a tensor's
# elements up to 0.0085 of its largest)
REMAT_GRAD_NORM_RTOL = 1e-4
REMAT_GRAD_MAX_REL = 0.02


def write_panoptic_root(root: Path, seed: int, n: int = PAN_IMAGES,
                        hw=PAN_HW):
    """A COCO panoptic root of `n` images at `hw` (the layout of the port's
    test root, scaled): per image a sky and a ground stuff band
    (categories 184, 187) and two thing boxes (1, 3) as an RGB id PNG, a
    JPEG of the segments' seeded colours with noise, and the annotations
    JSON -> (coco root, panoptic root)."""
    from PIL import Image

    from trackformer_tpu_torch.models.panoptic import id2rgb

    h, w = hw
    img_dir = root / "coco" / "val2017"
    pan_dir = root / "panoptic" / "panoptic_val2017"
    ann_dir = root / "panoptic" / "annotations"
    for d in (img_dir, pan_dir, ann_dir):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i in range(n):
        ids = (1000 + 10 * i, 1001 + 10 * i, 5000 + 10 * i, 5001 + 10 * i)
        seg = np.full((h, w), ids[0], np.int64)
        seg[h // 2 + (i - 1) * h // 12:] = ids[1]
        y, x = h // 5 + 20 * i, w // 8 + 40 * i
        seg[y:y + h // 3, x:x + w // 6] = ids[2]
        y, x = h // 2, w // 2 + 30 * i
        seg[y:y + h // 4, x:x + w // 7] = ids[3]
        Image.fromarray(id2rgb(seg)).save(pan_dir / f"{i:06d}.png")
        img = np.zeros((h, w, 3), np.float32)
        for sid in ids:
            img[seg == sid] = rng.uniform(40, 215, 3)
        img += rng.normal(0, 12, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            img_dir / f"{i:06d}.jpg", quality=90)
        images.append({"id": i, "file_name": f"{i:06d}.jpg", "height": h,
                       "width": w})
        annotations.append({"image_id": i, "file_name": f"{i:06d}.png",
                            "segments_info": [
                                {"id": sid, "category_id": cat, "iscrowd": 0,
                                 "area": int((seg == sid).sum())}
                                for sid, cat in zip(ids, (184, 187, 1, 3))]})
    (ann_dir / "panoptic_val2017.json").write_text(json.dumps(
        {"images": images, "annotations": annotations}))
    return root / "coco", root / "panoptic"


def panoptic_run(seed: int, n_frames: int, tmp: Path, card: str) -> dict:
    """COCO panoptic and vanilla DETR's attention maps on the card, each
    line with `card`, the card's nvidia-smi name and power limit:
      (a) the 250-class `DETRSegm` at the MOTS20 recipe's widths
          (`train.yaml` + `mots20` with `dataset=coco_panoptic`: hidden
          256, 6 + 6 layers, FFN 2048, 100 queries, 251 softmax logits,
          the mask heads, bf16) with seeded weights, its class head made
          sure of one thing category (smoke only), through `cli.train
          ... eval_only=true` over a synthetic panoptic root of
          `PAN_IMAGES` 800x1344 images at B = 2: box, mask and panoptic
          evaluation (PQ / SQ / RQ; random weights: plumbing), its PNGs,
          seconds a frame; no kernel launch (vanilla DETR);
      (b) the MOTS20 recipe's model as an `AttentionMapDETR`: the
          `Tracker` with attention maps over `n_frames` 800x1344 frames,
          `reset(hard=False)` halfway, ms a frame against the same run
          without maps; each result's map the memory's 25x42, finite, of
          a query's weights summing to at most 1;
      (c) `cli.track ... generate_attention_maps=true` over a synthetic
          MOTS20 layout (768x1344 frames), its Hz and rows. -> the
          launches of the runs by tag."""
    import contextlib
    import io

    from trackformer_tpu_torch.cli import train as cli_train
    from trackformer_tpu_torch.models.detr import AttentionMapDETR
    from trackformer_tpu_torch.tracking import Tracker
    from trackformer_tpu_torch.tracking.tracker import attn_hw_of
    from trackformer_tpu_torch.utils.checkpoint import save_model_npz
    from trackformer_tpu_torch.utils.config import (FlagshipConfig,
                                                    dump_config, load_config)

    out = {}
    # (a) COCO panoptic through the train CLI's evaluation
    t0 = time.perf_counter()
    coco_root, pan_root = write_panoptic_root(tmp / "pan", seed)
    phase("panoptic", card=json.dumps(card), images=PAN_IMAGES,
          image=f"{PAN_HW[0]}x{PAN_HW[1]}",
          write_s=f"{time.perf_counter() - t0:.2f}")
    train_cfg = load_config("train.yaml", ["mots20"],
                            {"dataset": "coco_panoptic"})
    cfg = FlagshipConfig.from_config(train_cfg)
    check((cfg.deformable, cfg.masks, cfg.focal_loss, cfg.hidden_dim,
           cfg.num_queries, cfg.dataset) == (False, True, False, 256, 100,
                                             "coco_panoptic"),
          f"panoptic: config {cfg}")
    model, _ = smoke_model(cfg, seed, "panoptic")
    check(type(model).__name__ == "DETRSegm"
          and model.class_embed.out_features == 251,
          f"panoptic: built {type(model).__name__}")
    with torch.no_grad():
        model.class_embed.bias.zero_()
        model.class_embed.bias[1] = 10.0     # every query a "person"
    ckpt = tmp / "pan" / "checkpoint.npz"
    save_model_npz(model, ckpt, cfg)
    dump_config(train_cfg, ckpt.parent / "config.yaml")
    del model
    run_dir = tmp / "pan" / "run"
    argv = ["with", "mots20", "dataset=coco_panoptic",
            f"coco_path={coco_root}", f"coco_panoptic_path={pan_root}",
            "train_split=val", "val_split=val", "tracking=false",
            "tracking_eval=false", "eval_only=true",
            f"batch_size={TRAIN_BATCH}", f"resume={ckpt}",
            f"output_dir={run_dir}"]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = cli_train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = out["panoptic_eval"] = launch_counts()
    record_path()
    pngs = sorted((run_dir / "panoptic_eval").glob("*.png"))
    segments = 0
    from PIL import Image

    from trackformer_tpu_torch.models.panoptic import rgb2id
    for f in pngs:
        with Image.open(f) as im:
            ids = rgb2id(np.asarray(im.convert("RGB")))
        check(ids.shape == PAN_HW, f"panoptic: PNG of {ids.shape}")
        segments += len(np.unique(ids))
    phase("panoptic_eval", card=json.dumps(card), batch=TRAIN_BATCH,
          frames=PAN_IMAGES, seconds=f"{seconds:.2f}",
          s_per_frame=f"{seconds / PAN_IMAGES:.3f}",
          peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
          pq=stats.get("PQ_all"), sq=stats.get("SQ_all"),
          rq=stats.get("RQ_all"), ap=stats.get("AP"),
          ap_masks=stats.get("AP_masks"), pngs=len(pngs), segments=segments,
          note=json.dumps("PQ and AP of random weights: plumbing"))
    check({"PQ_all", "SQ_all", "RQ_all", "AP_masks"} <= set(stats)
          and all(np.isfinite(stats[k]) for k in ("PQ_all", "SQ_all",
                                                    "RQ_all")),
          f"panoptic: stats {sorted(stats)}")
    check(len(pngs) == PAN_IMAGES and segments > PAN_IMAGES,
          f"panoptic: {len(pngs)} PNGs with {segments} segments")
    check(not any(counts.values()),
          f"panoptic: vanilla DETR launched {nonzero(counts)}")

    # (b) the attention-map Tracker with a soft reset, against the same
    # Tracker without maps
    rcfg = recipe_config()
    model, post = smoke_model(rcfg, seed, "attention_maps")
    wrapped = AttentionMapDETR(model)
    blobs = frame_blobs(n_frames, seed)
    tracker_args = (post, {**rcfg.tracker_cfg, "max_tracks": rcfg.max_tracks},
                    rcfg.hidden_dim, rcfg.num_queries, rcfg.overflow_boxes,
                    rcfg.masks)
    runs = {}
    for tag, tracker in (
            ("attention_maps", Tracker(wrapped, *tracker_args,
                                       attn_stride=wrapped.stride)),
            ("attention_maps_off", Tracker(model, *tracker_args))):
        frame_ms = []
        reset_launch_counts()
        for t, blob in enumerate(blobs):
            if t == n_frames // 2:
                tracker.reset(hard=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracker.step(blob)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        out[tag] = launch_counts()
        record_path()
        runs[tag] = (tracker, statistics.median(frame_ms[1:]))
    tracker, ms = runs["attention_maps"]
    results = tracker.get_results()
    hw = attn_hw_of(PAN_HW, wrapped.stride)
    maps = [e["attention_map"] for v in results.values() for e in v.values()]
    sums = [float(m.sum()) for m in maps]
    frames_seen = {f for v in results.values() for f in v}
    phase("attention_maps", card=json.dumps(card), frames=n_frames,
          image=f"{PAN_HW[0]}x{PAN_HW[1]}", soft_reset_at=n_frames // 2,
          ms_per_frame=f"{ms:.2f}",
          ms_per_frame_without_maps=f"{runs['attention_maps_off'][1]:.2f}",
          tracks=len(results), maps=len(maps), map_hw=list(hw),
          frame_index=tracker.frame_index,
          max_map_sum=f"{max(sums):.4f}" if sums else None)
    check(maps and all(m.shape == hw and np.isfinite(m).all()
                       and (m >= 0).all() for m in maps)
          and max(sums) <= 1.0 + 1e-3,
          f"attention_maps: {len(maps)} maps of shapes "
          f"{ {m.shape for m in maps} }")
    check(tracker.frame_index == n_frames
          and min(frames_seen) < n_frames // 2 <= max(frames_seen),
          f"attention_maps: frames {sorted(frames_seen)} around the soft "
          f"reset")
    check(not any(out["attention_maps"].values()),
          f"attention_maps: vanilla DETR launched "
          f"{nonzero(out['attention_maps'])}")
    del wrapped, model, runs, tracker

    # (c) the tracking CLI with attention maps over a MOTS20 layout
    write_mot_sequences(tmp, MASKS_SEQS[:1], MASKS_FRAMES, seed=seed + 5,
                        ext="jpg", mots=True)
    rmodel, _, rckpt = cli_checkpoint(rcfg, ["mots20"], seed,
                                      "attention_cli", tmp)
    del rmodel
    res_dir = tmp / "attention_cli_out"
    reset_launch_counts()
    summary, runtime = cli_main("attention_cli", track_argv(
        MASKS_SEQS[:1], tmp, rckpt, f"output_dir={res_dir}",
        "generate_attention_maps=true"))
    counts = out["attention_cli"] = launch_counts()
    record_path()
    rows = (res_dir / f"{MASKS_SEQS[0]}.txt").read_text().splitlines()
    phase("attention_cli", card=json.dumps(card), frames=MASKS_FRAMES,
          image=f"{CLI_BUCKET[0]}x{CLI_BUCKET[1]}",
          cli_hz=None if runtime is None else runtime[2], rows=len(rows))
    check(runtime is not None and runtime[1] == MASKS_FRAMES and rows,
          f"attention_cli: runtime {runtime}, {len(rows)} rows")
    check(not any(counts.values()),
          f"attention_cli: vanilla DETR launched {nonzero(counts)}")
    return out


def three_frame_pack(cfg, seed: int, step: int, hw=BUCKET, valid=VALID_HW):
    """`synthetic_train_pack` with a previous-previous frame: the pack of
    the frames one before, as the previous and previous-previous frames,
    under the current frame of this pack."""
    pack = synthetic_train_pack(cfg, seed, step, hw, valid)
    earlier = synthetic_train_pack(cfg, seed + 7, step, hw, valid)
    return {**pack, "prev_prev_batch": earlier["prev_batch"],
            "prev_prev_targets": earlier["prev_targets"]}


def train_extras_run(seed: int, card: str) -> dict:
    """Three-frame training, backprop through the previous frames and
    `tpu.remat` with the full-width exact flagship (`deformable tracking
    multi_frame`, bf16, B = 2, 800x1344, dropout 0.1), each line with
    `card`:
      (a) 2 three-frame steps (`track_prev_prev_frame`), then 2 with
          `backprop_prev_frame`, from the same start: launches
          (`THREE_STEP`, `THREE_BACKPROP_STEP`) and by shape, step ms (the
          second step's), peak memory;
      (b) two-frame steps with `tpu.remat` and without, from the same
          state and the same dropout draws, 2 at a time: at 800x1344 in
          turns (off, on, on, off), in the train CLI's 1088x1920 bucket
          once each: the first loss equal, its
          grad_norm and every gradient within `msda_bwd`'s atomics'
          drift, step ms (the second step's, the median of the turns)
          and peak memory
          both ways, the remat step's launches (`REMAT_STEP`);
      (c) one float32 three-frame step with backprop, card against the
          CPU's float32 and float64 steps (`train_reference_run`). -> the
          launches by tag."""
    import dataclasses

    from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                              make_train_step)
    from trackformer_tpu_torch.models import build_model
    from trackformer_tpu_torch.utils.config import FlagshipConfig

    out = {}
    cfg = FlagshipConfig().replace(dataset="mot_crowdhuman")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model, crit, _, track = build_model(cfg, "cuda", generator=gen,
                                        train=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = make_optimizer(cfg, model)

    def steps(tag, step_fn, packs, want):
        """`packs` through `step_fn` from the start state and draws ->
        (metrics of each step, the median ms of the steps after the first,
        the peak GiB)."""
        from trackformer_tpu_torch.ops import msda
        model.load_state_dict(start)
        state = TrainState.create(model, optimizer)
        gen.manual_seed(seed + 1)
        torch.cuda.reset_peak_memory_stats()
        ms, results = [], []
        for i, pack in enumerate(packs):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, pack, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = {k: v for k, v in launch_counts().items() if v}
            shapes = {f"{k[0]} N={k[1]} Lq={k[2]} L={len(k[3])}": n
                      for k, n in sorted(msda.launch_shapes().items(),
                                         key=str)}
            record_new_path(tag)
            out[tag] = counts
            loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
            phase(tag, card=json.dumps(card), step=i,
                  image="x".join(map(str, pack["batch"].images.shape[1:3])),
                  batch=TRAIN_BATCH, loss=f"{loss:.6f}",
                  grad_norm=f"{norm:.6f}", step_ms=f"{ms[-1]:.1f}",
                  peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
                  launches=json.dumps(counts, separators=(",", ":")),
                  by_shape=json.dumps(shapes, separators=(",", ":"))
                  if i == 0 else None)
            check(np.isfinite(loss) and np.isfinite(norm) and norm > 0,
                  f"{tag} step {i}: loss {loss}, grad_norm {norm}")
            check(counts == want, f"{tag} step {i}: launches {counts}, "
                                  f"want {want}")
            results.append(metrics)
        steady = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
        return results, steady, torch.cuda.max_memory_allocated() / 2**30

    # (a) three frames, then with backprop through the previous frames
    packs = [three_frame_pack(cfg, seed, i) for i in range(2)]
    summary = {}
    for tag, backprop, want in (("three_frame", False, THREE_STEP),
                                ("three_frame_backprop", True,
                                 THREE_BACKPROP_STEP)):
        fn = make_train_step(model, crit, optimizer, dataclasses.replace(
            track, backprop_prev_frame=backprop), tracking=True,
            prev_prev=True)
        res, ms, peak = steps(tag, fn, packs, want)
        summary[tag] = (float(res[0]["loss"]), ms, peak)
    check(any(key[2] == TRAIN_PREV_TRACK_QUERIES
              for key in NEW_SHAPES if key[0] == "ms_deform_attn"),
          "three_frame: no previous-frame decoder call with track queries")
    phase("three_frame", card=json.dumps(card),
          first_loss_stopped=f"{summary['three_frame'][0]:.6f}",
          first_loss_backprop=f"{summary['three_frame_backprop'][0]:.6f}",
          step_ms_stopped=f"{summary['three_frame'][1]:.1f}",
          step_ms_backprop=f"{summary['three_frame_backprop'][1]:.1f}",
          peak_gib_stopped=f"{summary['three_frame'][2]:.3f}",
          peak_gib_backprop=f"{summary['three_frame_backprop'][2]:.3f}")
    # backprop changes the gradient, not the forward
    check(summary["three_frame"][0] == summary["three_frame_backprop"][0],
          "three_frame: the first loss differs with backprop_prev_frame")

    # (b) remat on and off from the same state and draws
    big_hw, _ = TRAIN_BUCKETS["1088"]
    # in turns at 800x1344 (off, on, on, off): the host-bound step's time
    # drifts within a run
    for label, hw, valid, order in (
            ("800x1344", BUCKET, VALID_HW, (False, True, True, False)),
            ("1088x1920", big_hw, (1080, 1920), (False, True))):
        packs = [synthetic_train_pack(cfg, seed, i, hw, valid)
                 for i in range(2)]
        runs = {False: [], True: []}
        for remat in order:
            # the encoder's switch, as `build_model` sets it from the config
            model.transformer.encoder.remat = remat
            fn = make_train_step(model, crit, optimizer, track,
                                 tracking=True, return_grads=True)
            tag = f"remat_{'on' if remat else 'off'}_{label}"
            res, ms, peak = steps(tag, fn, packs,
                                  REMAT_STEP if remat else EXACT_STEP)
            runs[remat].append((res[0], ms, peak))
        model.transformer.encoder.remat = False
        got = {remat: (r[0][0], statistics.median(x[1] for x in r),
                       max(x[2] for x in r)) for remat, r in runs.items()}
        off, on = got[False][0], got[True][0]
        norm_rel = abs(float(on["grad_norm"]) - float(off["grad_norm"])) \
            / float(off["grad_norm"])
        worst = max(((on["_grads"][k] - g).abs().max()
                     / g.abs().max().clamp(min=1e-30)).item()
                    for k, g in off["_grads"].items())
        ok = (float(on["loss"]) == float(off["loss"])
              and norm_rel <= REMAT_GRAD_NORM_RTOL
              and worst <= REMAT_GRAD_MAX_REL)
        phase("remat", card=json.dumps(card), image=label,
              batch=TRAIN_BATCH, loss_off=f"{float(off['loss']):.6f}",
              loss_on=f"{float(on['loss']):.6f}",
              grad_norm_rel_diff=f"{norm_rel:.3e}",
              worst_grad_max_rel_diff=f"{worst:.3e}",
              tol=f"loss equal; grad_norm {REMAT_GRAD_NORM_RTOL:g} "
                  f"relative; each tensor max|d| <= {REMAT_GRAD_MAX_REL:g}"
                  f" max|g|",
              step_ms_off=f"{got[False][1]:.1f}",
              step_ms_on=f"{got[True][1]:.1f}",
              peak_gib_off=f"{got[False][2]:.3f}",
              peak_gib_on=f"{got[True][2]:.3f}", ok=ok)
        check(ok, f"remat at {label}: loss {float(on['loss'])} against "
                  f"{float(off['loss'])}, grad_norm {norm_rel:.3e}, "
                  f"gradients {worst:.3e} apart")
        del runs, got, off, on
    del model, start
    torch.cuda.empty_cache()

    # (c) a float32 three-frame step with backprop, card against the CPU
    train_reference_run(seed, label="three_frame_reference", prev_prev=True)
    return out


PHASES = ("msda", "window", "msda_bwd", "dense_v2", "dense_v4", "dense_v3",
          "gather_rows", "patch_v6", "exact", "fast", "train",
          "train_reference", "train_fast", "checkpoint", "evaluate",
          "track_cli", "train_cli", "variants", "agreement", "masks",
          "family", "panoptic", "train_extras")
# frames of the exact tracker's runs on the other routes
ROUTE_FRAMES = 3


def main() -> int:
    global OLD_BWD_LIB, OLD_FWD_LIB, OLD_WINDOW_LIB, OLD_V2_LIB, OLD_V4_LIB
    global OLD_V3_LIB, OLD_V6_LIB, OLD_WALK_LIB, OLD_ROWS_LIB
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=6,
                    help="frames of each tracker run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--old-msda-bwd", default=None, metavar="PATH",
                    help="an earlier csrc/msda_bwd.cu (a copy outside the "
                         "package) to time beside the backward kernel")
    ap.add_argument("--old-msda-fwd", default=None, metavar="PATH",
                    help="an earlier csrc/msda_fwd.cu (a copy outside the "
                         "package) to time beside the forward kernel")
    ap.add_argument("--old-window-layer", default=None, metavar="PATH",
                    help="an earlier csrc/window_layer_fwd.cu (a copy "
                         "outside the package) to time beside the window "
                         "layer's kernels")
    for kind in ("v2", "v4", "v3"):
        ap.add_argument(f"--old-dense-{kind}", default=None, metavar="PATH",
                        help=f"an earlier csrc/msda_dense_{kind}_fwd.cu (a "
                             "copy outside the package, beside the "
                             "msda_common.cuh it was built with) to time "
                             "beside that kernel")
    ap.add_argument("--old-walk", default=None, metavar="PATH",
                    help="an earlier one-level walk, csrc/msda_dense_v4_fwd"
                         ".cu (a copy outside the package, beside the "
                         "msda_common.cuh it was built with), to time "
                         "beside the block-skipping and range-walking "
                         "kernels")
    ap.add_argument("--old-patch-v6", default=None, metavar="PATH",
                    help="an earlier csrc/msda_patch_v6_fwd.cu (a copy "
                         "outside the package, beside the msda_common.cuh "
                         "it was built with) to time beside the flat walk")
    ap.add_argument("--old-gather-rows", default=None, metavar="PATH",
                    help="an earlier csrc/msda_gather_rows_fwd.cu (a copy "
                         "outside the package, beside the msda_common.cuh "
                         "it was built with) to time beside the gather")
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
    from trackformer_tpu_torch import native
    from trackformer_tpu_torch.ops import msda
    from trackformer_tpu_torch.ops.cuda_build import NVCC_FLAGS, build_all
    from trackformer_tpu_torch.ops.window_attn import STAGES
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
    if args.old_msda_fwd:
        OLD_FWD_LIB = old_fwd_lib(args.old_msda_fwd)
        libs.append(OLD_FWD_LIB)
    if args.old_window_layer:
        OLD_WINDOW_LIB = old_window_lib(args.old_window_layer)
        libs.append(OLD_WINDOW_LIB)
    if args.old_dense_v2:
        OLD_V2_LIB = old_dense_lib(args.old_dense_v2, "v2")
        libs.append(OLD_V2_LIB)
    if args.old_dense_v4:
        OLD_V4_LIB = old_dense_lib(args.old_dense_v4, "v4")
        libs.append(OLD_V4_LIB)
    if args.old_dense_v3:
        OLD_V3_LIB = old_dense_lib(args.old_dense_v3, "v3")
        libs.append(OLD_V3_LIB)
    if args.old_patch_v6:
        OLD_V6_LIB = old_patch_lib(args.old_patch_v6)
        libs.append(OLD_V6_LIB)
    if args.old_walk:
        OLD_WALK_LIB = old_walk_lib(args.old_walk)
        libs.append(OLD_WALK_LIB)
    if args.old_gather_rows:
        OLD_ROWS_LIB = old_rows_lib(args.old_gather_rows)
        libs.append(OLD_ROWS_LIB)
    build_all(libs)
    for lib in libs:
        info = lib.info()
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        phase("build", source=info["source"],
              flags=json.dumps(" ".join(NVCC_FLAGS[:2])),
              seconds=f"{info['seconds']:.2f}", ptxas=json.dumps(regs))
    # the native host library of the serving entry point (g++)
    t1 = time.perf_counter()
    so = native.build()
    phase("build", source=str(native.SOURCE.relative_to(REPO)),
          flags=json.dumps(" ".join(native.CXX_FLAGS)), library=so.name,
          seconds=f"{time.perf_counter() - t1:.2f}")
    phase("build", all_seconds=f"{time.perf_counter() - t0:.2f}")

    # the deployed tracking checkpoint (cfgs/track.yaml) is trained on
    # mot_crowdhuman: a 20-class head
    exact_cfg = FlagshipConfig().replace(dataset="mot_crowdhuman")
    fast_cfg = FlagshipConfig.tpu_fast(dataset="mot_crowdhuman")
    kmsda = kwin = kbwd = kv2 = kv4 = kv3 = krows = kv6 = None
    mark = [time.perf_counter()]

    def lap(name: str) -> None:
        """The seconds since the last lap, as a `timing` line, if one of
        the phases of `name` ran."""
        now = time.perf_counter()
        if any(n in phases for n in name.split("+")):
            phase("timing", phases=name, seconds=f"{now - mark[0]:.1f}")
        mark[0] = now

    fast_counts = batched_counts = cli_counts = train_cli_counts = None
    variant_counts = agree_counts = knew = family_counts = None
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if "msda" in phases:
            kmsda = kernel_phase_msda(args.seed)
        lap('msda')
        if "window" in phases:
            kwin = kernel_phase_window(args.seed)
        lap('window')
        if "msda_bwd" in phases:
            kbwd = kernel_phase_msda_bwd(args.seed)
        lap('msda_bwd')
        if "dense_v2" in phases:
            kv2 = kernel_phase_dense_v2(args.seed)
        lap('dense_v2')
        if "dense_v4" in phases:
            kv4 = kernel_phase_dense_v4(args.seed)
        lap('dense_v4')
        if {"dense_v3", "gather_rows", "patch_v6"} & set(phases):
            captured = captured_encoder_call(args.seed)
            if "dense_v3" in phases:
                kv3 = kernel_phase_dense_v3(args.seed, captured)
            if "gather_rows" in phases:
                krows = kernel_phase_gather_rows(args.seed, captured)
            if "patch_v6" in phases:
                kv6 = kernel_phase_patch_v6(args.seed, captured)
            del captured

        lap('dense_v3+gather_rows+patch_v6')
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

        lap('exact')
        if "fast" in phases:
            model, post = smoke_model(fast_cfg, args.seed, "fast")
            fast_counts = tracker_run("fast", fast_cfg, model, post,
                                      args.frames, args.seed,
                                      FAST_PER_FRAME)[0]
            batched_counts = batched_run(fast_cfg, model, post, 8, 4,
                                         args.seed)
            reference_run("fast", model, 2)
            del model

        lap('fast')
        if "track_cli" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                cli_counts = track_cli_run(args.seed, exact_cfg, fast_cfg,
                                           Path(tmp))
        lap('track_cli')
        if "train_cli" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                train_cli_counts = train_cli_run(args.seed, Path(tmp), smi)

        lap('train_cli')
        if "train_fast" in phases or "checkpoint" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                fast_train_run(args.seed, "checkpoint" in phases,
                               Path(tmp) / "run")
                if "checkpoint" in phases:
                    npz_round_trip(exact_cfg, args.seed, "exact", Path(tmp))
                    npz_round_trip(fast_cfg, args.seed, "fast", Path(tmp))
        lap('train_fast+checkpoint')
        if "train_fast" in phases:
            train_reference_run(args.seed, fast=True)
        lap('train_fast')
        if "evaluate" in phases:
            evaluate_run(exact_cfg, args.seed, "exact",
                         {"msda_patch": 12, "ms_deform_attn": 6})
            evaluate_run(fast_cfg, args.seed, "fast", FAST_PER_FRAME)
        lap('evaluate')
        if "train" in phases:
            train_run(args.seed)
        lap('train')
        if "train_reference" in phases:
            # a second seed: the limits were not fitted to one draw
            train_reference_run(args.seed)
            train_reference_run(args.seed + 1)
        lap('train_reference')
        if "variants" in phases:
            variant_counts = variants_run(args.seed, args.frames)
        lap('variants')
        if "agreement" in phases:
            agree_counts = agreement_run(args.seed)
        lap('agreement')
        if "masks" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                masks_run(args.seed, args.frames, Path(tmp), smi)
        lap('masks')
        if "family" in phases:
            family_counts = family_run(args.seed, args.frames)
        lap('family')
        if "panoptic" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                panoptic_run(args.seed, args.frames, Path(tmp), smi)
        lap('panoptic')
        if "train_extras" in phases:
            train_extras_run(args.seed, smi)
        lap('train_extras')
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    # the results of a kernel phase that did not run (a partial run) read
    # as empty
    kmsda, kwin, kbwd, kv2, kv4, kv3, krows, kv6 = (
        NotRun() if k is None else k
        for k in (kmsda, kwin, kbwd, kv2, kv4, kv3, krows, kv6))
    csrc = "trackformer_tpu_torch/csrc/"
    msda_src, win_src = csrc + "msda_fwd.cu", csrc + "window_layer_fwd.cu"
    bwd_src = csrc + "msda_bwd.cu"
    # one walk serves the block-skipping (v2), range-walking (v4), sorted
    # x-windowed (v3) and flat-walk (v6) kernels
    v4_src = v2_src = v3_src = v6_src = csrc + "msda_dense_v4_fwd.cu"
    rows_src = csrc + "msda_gather_rows_fwd.cu"
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
        ("msda_fwd via msda_patch (training, and the train CLI's "
         "validation, encoder, all levels, B = 2)",
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
         "and the train CLI's validation, 8 levels, 500 queries, B = 2)",
         msda_src, dense_py + ":216", kmsda[("decoder_train_prev", bf16)],
         ("ms_deform_attn", TRAIN_BATCH, TRAIN_PREV_QUERIES, dec_levels)),
        ("msda_fwd via ms_deform_attn (evaluate and single-frame forwards, "
         "decoder, 8 levels, 500 queries, B = 1)",
         msda_src, dense_py + ":216", kmsda[("decoder_eval", bf16)],
         ("ms_deform_attn", 1, EVAL_DEC_QUERIES, dec_levels)),
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
            (f"msda_dense_v4_fwd via dense_level_pallas_v3 (encoder level "
             f"{lvl} {hw[0]}x{hw[1]} of a captured call, B = 1)",
             v3_src, dense_py + ":270", {**kv3[lvl], "path": no_route},
             ("dense_level_pallas_v3", 1, s_enc, (hw,))),
            ("msda_dense_v4_fwd via dense_level_pallas_v2 (training, " + at,
             v2_src, dense_py + ":68", kv2[lvl],
             ("dense_level_pallas_v2", TRAIN_BATCH, s_enc, (hw,)))]
    msda_entries += [
        ("msda_dense_v4_fwd via dense_level_pallas_v4p (MSDA_DEC_SKIP, "
         "decoder level 100x168, 650 queries, B = 1)",
         v4_src, dense_py + ":356", kv4[("dec", 1, DEC_QUERIES)],
         ("dense_level_pallas_v4", 1, DEC_QUERIES, (LEVELS[0],))),
        ("msda_gather_rows_fwd via ms_deform_attn_pallas (a captured "
         "encoder call, all levels, B = 1)",
         rows_src, pallas_py + ":34",
         {**krows[("gather", "encoder")], "path": no_route},
         ("ms_deform_attn_pallas", 1, s_enc, LEVELS)),
        ("msda_gather_rows_fwd via ms_deform_attn_pallas (the decoder "
         "call's shape, 8 levels, 650 queries, B = 1)",
         rows_src, pallas_py + ":34",
         {**krows[("gather", "decoder")], "path": no_route},
         ("ms_deform_attn_pallas", 1, DEC_QUERIES, dec_levels)),
        ("msda_corners_fwd via ms_deform_attn_pallas (its corner operands, "
         "a captured encoder call, B = 1)",
         rows_src, pallas_py + ":67",
         {**krows[("corners", "encoder")], "path": no_route},
         ("ms_deform_attn_pallas_corners", 1, s_enc, LEVELS)),
        ("msda_corners_fwd via ms_deform_attn_pallas (its corner operands, "
         "the decoder call's shape, B = 1)",
         rows_src, pallas_py + ":67",
         {**krows[("corners", "decoder")], "path": no_route},
         ("ms_deform_attn_pallas_corners", 1, DEC_QUERIES, dec_levels)),
        ("msda_dense_v4_fwd via msda_patch_v6 (a captured encoder call, all "
         "levels, B = 1)",
         v6_src, patch_py + ":411", {**kv6, "path": no_route},
         ("msda_patch_v6", 1, s_enc, LEVELS)),
    ]
    s_cli = sum(h * w for h, w in CLI_LEVELS)
    cli_dec_levels = CLI_LEVELS * 2
    msda_entries += [
        ("msda_fwd via msda_patch (cli.track, 768x1344 frames, exact "
         "encoder, all levels, B = 1)",
         msda_src, patch_py + ":108", kmsda[("encoder_cli", bf16)],
         ("msda_patch", 1, s_cli, CLI_LEVELS)),
        ("msda_fwd via ms_deform_attn (cli.track, 768x1344 frames, decoder, "
         "8 levels, B = 1)",
         msda_src, dense_py + ":216", kmsda[("decoder_cli", bf16)],
         ("ms_deform_attn", 1, DEC_QUERIES, cli_dec_levels)),
        ("msda_fwd via ms_deform_attn (cli.track, 768x1344 frames, decoder, "
         "8 levels, lockstep B = 8)",
         msda_src, dense_py + ":216", kmsda[("decoder_cli_b8", bf16)],
         ("ms_deform_attn", 8, DEC_QUERIES, cli_dec_levels)),
    ]
    for tag, (bucket, levels) in TRAIN_BUCKETS.items():
        s_lv, both = sum(h * w for h, w in levels), levels * 2
        at = f"the train CLI's {bucket[0]}x{bucket[1]} bucket"
        msda_entries += [
            (f"msda_fwd via msda_patch (training, {at}, encoder, all "
             f"levels, B = 2)",
             msda_src, patch_py + ":108", kmsda[(f"encoder_train_{tag}",
                                                 bf16)],
             ("msda_patch", TRAIN_BATCH, s_lv, levels)),
            (f"msda_fwd via ms_deform_attn (training, {at}, decoder, 8 "
             f"levels, 611 queries, B = 2)",
             msda_src, dense_py + ":216", kmsda[(f"decoder_train_{tag}",
                                                 bf16)],
             ("ms_deform_attn", TRAIN_BATCH, TRAIN_DEC_QUERIES, both)),
            (f"msda_fwd via ms_deform_attn (training, {at}, previous "
             f"frame's decoder, 8 levels, 500 queries, B = 2)",
             msda_src, dense_py + ":216",
             kmsda[(f"decoder_train_prev_{tag}", bf16)],
             ("ms_deform_attn", TRAIN_BATCH, TRAIN_PREV_QUERIES, both)),
            (f"msda_bwd (training, {at}, encoder call, all levels, B = 2)",
             bwd_src, patch_py + ":367", kbwd[(f"encoder_{tag}", bf16)],
             ("msda_bwd", TRAIN_BATCH, s_lv, levels)),
            (f"msda_bwd (training, {at}, decoder call, 8 levels, B = 2)",
             bwd_src, dense_py + ":780", kbwd[(f"decoder_{tag}", bf16)],
             ("msda_bwd", TRAIN_BATCH, TRAIN_DEC_QUERIES, both)),
        ]
    # the gather kernel's and the backward's launches are counted with the
    # channels of a head, 36 at the flagship's hidden 288
    msda_entries = [e[:4] + (channel_key(e[4]),) for e in msda_entries]
    static = {e[4] for e in msda_entries}
    try:
        # every MSDA shape the variants and agreement phases launched that
        # no entry above holds, held at that shape
        knew = kernel_phase_path_shapes(set(NEW_SHAPES) - static, args.seed)
        phase("timing", phases="path_shapes",
              seconds=f"{time.perf_counter() - mark[0]:.1f}")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    for key, result in sorted(knew.items(), key=lambda kv: str(kv[0])):
        wrapper, n, lq, levels, d = key
        bwd = wrapper == "msda_bwd"
        encoder = lq == sum(h * w for h, w in levels)
        replaces = (patch_py + (":367" if bwd else ":108") if encoder
                    else dense_py + (":780" if bwd else ":216"))
        msda_entries.append((
            f"{'msda_bwd' if bwd else 'msda_fwd via ' + wrapper} "
            f"({', '.join(sorted(NEW_SHAPES[key]))}: "
            f"{'encoder' if encoder else 'decoder'}, {len(levels)} levels "
            f"{levels[0][0]}x{levels[0][1]}.., {lq} queries, B = {n}, "
            f"D = {d})",
            bwd_src if bwd else msda_src, replaces, result, key))

    if phases != list(PHASES):
        print(json.dumps({"ok": True, "partial": phases, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

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
                 f"B = {batch}: the five stage kernels)",
         "route": "cuda", "source": win_src,
         "replaces": "trackformer_tpu/ops/window_attn.py:56",
         "launches": counts["fused_window_layer"], **kwin[batch]}
        for batch, counts in ((1, fast_counts), (8, batched_counts))]
    kernels += [
        {"name": f"{stage} via fused_window_layer (fast encoder, B = 8)",
         "route": "cuda", "source": win_src,
         "replaces": "trackformer_tpu/ops/window_attn.py:56",
         "launches": batched_counts[stage], **kwin[stage]}
        for stage in STAGES]
    kernels += [
        {"name": f"window_layer_fwd via fused_window_layer (cli.track, "
                 f"768x1344 frames, fast encoder, B = {batch}: the five "
                 f"stage kernels)",
         "route": "cuda", "source": win_src,
         "replaces": "trackformer_tpu/ops/window_attn.py:56",
         "launches": cli_counts[run]["fused_window_layer"],
         **kwin[("cli", batch)]}
        for batch, run in ((1, "fast_b1"), (8, "fast_b8"))]
    kernels += [
        {"name": f"{stage} via fused_window_layer (cli.track, 768x1344 "
                 f"frames, fast encoder, B = 8)",
         "route": "cuda", "source": win_src,
         "replaces": "trackformer_tpu/ops/window_attn.py:56",
         "launches": cli_counts["fast_b8"][stage], **kwin[("cli", stage)]}
        for stage in STAGES]
    kernels.append(
        {"name": "window_layer_fwd via fused_window_layer (the train CLI's "
                 "validation of the fast mode, 800x1344, B = 2: the five "
                 "stage kernels)",
         "route": "cuda", "source": win_src,
         "replaces": "trackformer_tpu/ops/window_attn.py:56",
         "launches": train_cli_counts["train_cli_fast"]["fused_window_layer"],
         **kwin[2]})
    # this slice's shapes: C = 256 in the single-frame fast model's
    # `Tracker` (B = 1) and eval forward (B = 2, each stage kernel too),
    # C = 288 in the agreement runs (416x544 B = 4 bf16, 192x256 B = 1
    # float32)
    win_new = [
        ("window_layer_fwd via fused_window_layer (single-frame fast model, "
         "C = 256, 800x1344, B = 1: the five stage kernels)",
         variant_counts["variant_fast"]["fused_window_layer"],
         kwin[("c256", 1)]),
        ("window_layer_fwd via fused_window_layer (single-frame fast model, "
         "C = 256, eval forward, 800x1344, B = 2: the five stage kernels)",
         variant_counts["variant_fast_eval_b2"]["fused_window_layer"],
         kwin[("c256", 2)]),
        ("window_layer_fwd via fused_window_layer (agreement detection, "
         "fast arm's eval, C = 288, 416x544, B = 4: the five stage "
         "kernels)", agree_counts["det_fast"]["fused_window_layer"],
         kwin[("agree", 4)]),
        ("window_layer_f32 via fused_window_layer (agreement tracking, fast "
         "arm's Tracker, C = 288, float32, 192x256, B = 1)",
         agree_counts["track_fast"]["window_layer_f32"],
         kwin[("agree_mid", 1)])]
    win_new += [
        (f"{stage} via fused_window_layer (single-frame fast model, C = 256, "
         f"eval forward, 800x1344, B = 2)",
         variant_counts["variant_fast_eval_b2"][stage], kwin[("c256", stage)])
        for stage in STAGES]
    # kernel #8 at window side 16 (256-token windows): the fast flagship's
    # `Tracker` (B = 1) and `BatchedTracker` (B = 8), each stage kernel at
    # both, and the `fast_w16` agreement arm's eval (416x544, B = 4)
    w16_runs = (("Tracker", 1, "w16_b1", family_counts["fast_w16"]),
                ("BatchedTracker", 8, "w16_b8",
                 family_counts["fast_w16_batched"]))
    for run, batch, key, counts in w16_runs:
        win_new.append(
            (f"window_layer_fwd via fused_window_layer (fast flagship at "
             f"window side 16, 256-token windows, {run}, 800x1344, B = "
             f"{batch}: the five stage kernels)",
             counts["fused_window_layer"], kwin[(key, batch)]))
        win_new += [
            (f"{stage} via fused_window_layer (fast flagship at window side "
             f"16, {run}, 800x1344, B = {batch})", counts[stage],
             kwin[(key, stage)]) for stage in STAGES]
    win_new.append(
        ("window_layer_fwd via fused_window_layer (agreement detection, "
         "fast_w16 arm's eval, window side 16, C = 288, 416x544, B = 4: the "
         "five stage kernels)",
         family_counts["agree_fast_w16"]["fused_window_layer"],
         kwin[("agree_w16", 4)]))
    kernels += [{"name": name, "route": "cuda", "source": win_src,
                 "replaces": "trackformer_tpu/ops/window_attn.py:56",
                 "launches": launches, **result}
                for name, launches, result in win_new]
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
