"""All-levels MSDA for the encoder self-pattern (Lq == S).

Counterpart of `msda_patch` and `msda_patch_v6` in
`trackformer_tpu/ops/msda_patch.py`.

`msda_patch`: the TPU's fused patch-walk kernel `_kernel_v5` walks value
chunks per query tile. On the card the same function is one launch of the
gather kernel in `csrc/msda_fwd.cu` over all levels (see `ops/msda.py`); on
a CPU tensor it is the plain version. It keeps the TPU contract: every
level at once, and queries are the level tokens themselves (Lq == S). The
output is (N, Lq, M, D) in the value dtype, where the TPU kernel returns
float32; its one caller casts to the value dtype either way.
Differentiable (`ops/msda.py:MSDAFunction`).

`msda_patch_v6`: the TPU's `_kernel_v6` tiles the queries in the static
`snake_bucket_perm` order and runs one loop over a precomputed flat list of
the value chunks each tile's samples cover on all levels (`v6_walk`), with
a ring of chunk copies in flight. On the card: one launch of the walk of
`csrc/msda_dense_v4_fwd.cu` over all levels (`ops/msda_dense.py`:
`levels_plan`, `launch_walk`): tiles in the same snake order, each block
finding its own occupied windows level by level, so no list is built; no
window leaves a tile's occupied cells, so it reads no cell outside the
chunks `v6_walk` lists. -> (N, Lq, M, D) float32 as the TPU kernel returns
it; the backward is the backward kernel of `ops/msda.py` over all levels.
On a CPU tensor it is the plain version. No route calls it, as in the JAX
package. `v6_walk` stays as the plain counterpart of the JAX wrapper's
list (its tests hold the walk's bounds).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .msda import (_check_inputs, count_launch, ms_deform_attn_plain,
                   msda_bwd_cuda, msda_cuda)
from .msda_dense import V3_CW, launch_walk, levels_plan

# `v6_walk`'s defaults: queries per tile, chunk rows and columns in cells
V6_TQ = 128
V6_PH = 8
V6_PW = 32
# the walk's column chunks on every level: its dense windows of 16 columns
V6_CW = V3_CW


def msda_patch(value: torch.Tensor,
               spatial_shapes: Sequence[Tuple[int, int]],
               sampling_locations: torch.Tensor,
               attention_weights: torch.Tensor) -> torch.Tensor:
    """value (N, S, M, D); sampling_locations (N, S, M, L, P, 2);
    attention_weights (N, S, M, L, P) -> (N, S, M, D)."""
    s = value.shape[1]
    lq = sampling_locations.shape[1]
    if lq != s:
        raise ValueError(f"msda_patch needs Lq == S, got Lq={lq}, S={s}")
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights).to(value.dtype)
    return msda_cuda(value, spatial_shapes, sampling_locations,
                     attention_weights, "msda_patch")


# --------------------------------------------------------------------------
# flat precomputed chunk walk (TPU kernel v6)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def snake_bucket_perm(spatial_shapes, bucket: int = 8):
    """Static permutation that sorts the S = sum H_l * W_l encoder tokens by
    their place in the image: tokens are bucketed on the level-0 grid
    (`bucket` level-0 cells a side), buckets ordered boustrophedon (odd
    bucket rows reversed), ties in the level-major raster order (stable
    sort). -> (perm, inv) int32 numpy arrays: sorted[i] = tokens[perm[i]],
    tokens[j] = sorted[inv[j]]."""
    h0, w0 = spatial_shapes[0]
    nbx = -(-w0 // bucket)
    keys = []
    for h, w in spatial_shapes:
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        y0 = (yy + 0.5) / h * h0
        x0 = (xx + 0.5) / w * w0
        by = np.minimum(y0 / bucket, -(-h0 // bucket) - 1).astype(np.int64)
        bx = np.minimum(x0 / bucket, nbx - 1).astype(np.int64)
        bx_snake = np.where(by % 2 == 0, bx, nbx - 1 - bx)
        keys.append((by * nbx + bx_snake).reshape(-1))
    perm = np.argsort(np.concatenate(keys), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return perm, inv


@functools.lru_cache(maxsize=None)
def _snake_perm_on(spatial_shapes, device) -> torch.Tensor:
    # outside inference mode: the cached tensor also serves training calls
    with torch.inference_mode(False):
        return torch.from_numpy(
            snake_bucket_perm(spatial_shapes)[0]).to(device)


def v6_max_chunks(spatial_shapes, ph: int, pw: int) -> int:
    """Every chunk of every level: the longest list a tile can walk."""
    return sum(-(-h // ph) * -(-w // pw) for h, w in spatial_shapes)


def v6_walk(spatial_shapes: Sequence[Tuple[int, int]],
            sampling_locations: torch.Tensor, tq: Optional[int] = None,
            ph: Optional[int] = None, pw: Optional[int] = None):
    """Plain version of kernel v6's walk, in tensor code on the locations'
    device as the JAX wrapper builds it: sampling_locations
    (N, S, M, L, P, 2), tiled by `tq` in `snake_bucket_perm` order ->
    (codes (N, nQ, MAXC) int32, totals (N, nQ) int32). Per tile and level
    the rectangle of `ph` x `pw`-cell chunks that holds the samples' corner
    cells, `floor(min) .. floor(max) + 1` clipped into the level; the
    rectangles of all levels one after the other, row-major, as codes
    `level << 20 | chunk row << 10 | chunk column`; entries past a tile's
    total are unused. Queries past S are left out, not padded."""
    tq = V6_TQ if tq is None else tq
    ph = V6_PH if ph is None else ph
    pw = V6_PW if pw is None else pw
    shapes = tuple(tuple(hw) for hw in spatial_shapes)
    n, s, m, l, p, _ = sampling_locations.shape
    if max(-(-h // ph) for h, _ in shapes) > 1024 \
            or max(-(-w // pw) for _, w in shapes) > 1024 or l >= 2048:
        raise ValueError("v6_walk: a chunk grid past the code's 10 bits per "
                         "axis")
    dev = sampling_locations.device
    maxc = v6_max_chunks(shapes, ph, pw)
    loc_s = sampling_locations[:, _snake_perm_on(shapes, dev).long()].float()
    n_q = -(-s // tq)
    pad = (0, 0, 0, 0, 0, 0, 0, n_q * tq - s)
    rect = []          # (cylo, cyhi, cxlo, cxhi), each (N, nQ, L)
    for axis, cell in ((1, ph), (0, pw)):
        size = torch.tensor([hw[1 - axis] for hw in shapes],
                            dtype=torch.float32, device=dev)
        c = loc_s[..., axis] * size[:, None] - 0.5          # (N, S, M, L, P)
        lo = torch.nn.functional.pad(c, pad, value=float("inf"))
        hi = torch.nn.functional.pad(c, pad, value=-float("inf"))
        lo = lo.reshape(n, n_q, tq, m, l, p).amin((2, 3, 5))
        hi = hi.reshape(n, n_q, tq, m, l, p).amax((2, 3, 5))
        top = size - 1
        rect += [(torch.minimum(torch.floor(lo).clamp(min=0), top)
                  // cell).long(),
                 (torch.minimum((torch.floor(hi) + 1).clamp(min=0), top)
                  // cell).long()]
    cylo, cyhi, cxlo, cxhi = rect
    nx = cxhi - cxlo + 1
    counts = (cyhi - cylo + 1) * nx                          # (N, nQ, L)
    cum = torch.cat([torch.zeros_like(counts[..., :1]),
                     counts.cumsum(-1)], -1)                 # (N, nQ, L + 1)
    totals = cum[..., -1]
    j = torch.arange(maxc, device=dev)
    lvl_j = (j[None, None, None, :] >= cum[..., 1:, None]).sum(-2)
    lvl_j = lvl_j.clamp(max=l - 1)                           # (N, nQ, MAXC)
    t_j = (j - torch.gather(cum, -1, lvl_j)).clamp(min=0)
    nx_j = torch.gather(nx, -1, lvl_j)
    cy = torch.gather(cylo, -1, lvl_j) + t_j // nx_j
    cx = torch.gather(cxlo, -1, lvl_j) + t_j % nx_j
    codes = (lvl_j << 20) + (cy << 10) + cx
    return codes.to(torch.int32).contiguous(), totals.to(torch.int32)


def msda_patch_v6_fwd_cuda(value: torch.Tensor,
                           spatial_shapes: Sequence[Tuple[int, int]],
                           sampling_locations: torch.Tensor,
                           attention_weights: torch.Tensor,
                           tq: Optional[int] = None) -> torch.Tensor:
    """One launch of the walk over all levels, tiles of `tq` queries (None:
    the plan's) in `snake_bucket_perm` order, served as `levels_plan` says
    -> (N, S, M, D) float32. Counts the launch as "msda_patch_v6"."""
    _check_inputs(value, spatial_shapes, sampling_locations,
                  attention_weights)
    n, s, m, d = value.shape
    lq, p = sampling_locations.shape[1], sampling_locations.shape[4]
    if lq != s:
        raise ValueError(f"msda_patch_v6 needs Lq == S, got Lq={lq}, S={s}")
    shapes = tuple(tuple(int(v) for v in hw) for hw in spatial_shapes)
    plan = levels_plan(n, s, m, p, d, shapes, value.element_size(),
                       value.data_ptr() % 16, V6_CW, tq)
    out = launch_walk(value, sampling_locations, attention_weights, plan,
                      V6_CW, perm_shared=_snake_perm_on(shapes, value.device))
    count_launch("msda_patch_v6", n, s, shapes)
    return out


class PatchV6Function(torch.autograd.Function):
    """The flat-walk forward with the shared MSDA backward kernel over all
    levels as its gradient."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes):
        out = msda_patch_v6_fwd_cuda(value, spatial_shapes,
                                     sampling_locations, attention_weights)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        return (*msda_bwd_cuda(grad_out, value, ctx.spatial_shapes, loc,
                               attn), None)


def msda_patch_v6(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor) -> torch.Tensor:
    """value (N, S, M, D); sampling_locations (N, S, M, L, P, 2);
    attention_weights (N, S, M, L, P) -> (N, S, M, D) float32."""
    s = value.shape[1]
    lq = sampling_locations.shape[1]
    if lq != s:
        raise ValueError(f"msda_patch_v6 needs Lq == S, got Lq={lq}, S={s}")
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    return PatchV6Function.apply(value.contiguous(),
                                 sampling_locations.contiguous(),
                                 attention_weights.contiguous(),
                                 tuple(tuple(hw) for hw in spatial_shapes))
