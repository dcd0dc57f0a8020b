"""One level's MSDA contribution: the per-level functions of the JAX
package.

Counterpart of `dense_level_pallas`, `dense_level_pallas_v2`,
`dense_level_pallas_v3`, `dense_level_pallas_v4` and
`dense_level_pallas_v4p` in `trackformer_tpu/ops/msda_dense.py`. All compute
one function (`ops/msda.py:level_plain`); they differ in what they read.

`dense_level_pallas`: the TPU's v1 kernel `_kernel` builds the level's
bilinear hat weights as a dense (query, cell) tile and multiplies it with
the values. On the card the same function is one launch of the gather
kernel in `csrc/msda_fwd.cu` with this single level (see `ops/msda.py`).
The main path does not call it on the card: there `ms_deform_attn` takes
all eight decoder levels, this one included, in one launch. It is kept at
its TPU contract so that the kernel can be held against the v1 kernel at
the decoder's single-level shape.

`dense_level_pallas_v2`: the TPU's `_kernel_v2` skips every (query tile,
row tile) pair whose row ranges miss. On the card it is one launch of the
walk of `csrc/msda_dense_v4_fwd.cu` (below); route "v2" of `ms_deform_attn`
reaches it for every level of the flagship encoder call.

`dense_level_pallas_v4` / `dense_level_pallas_v4p`: the TPU's `_kernel_v4`
walks, per query tile, the tile's own row range and range of column chunks
(`v4_ranges`) with double-buffered copies; `v4p` tiles the queries in the
order of a caller's permutation (`spatial_sort_perm`). On the card: one
launch of `csrc/msda_dense_v4_fwd.cu`. Route "v4" of `ms_deform_attn`
reaches it for every level of the encoder call, `MSDA_DEC_SKIP` for the
decoder's fine levels.

`dense_level_pallas_v3`: the TPU's `_kernel_v3` sorts the queries, keeps
v2's row band and computes a tile on one window of `cw` columns when its
occupied columns fit (`v3_windows`), else on the full width. No route calls
it, as in the JAX package.

All three compute one function and launch one kernel and C entry point,
the walk of `csrc/msda_dense_v4_fwd.cu` (which also serves the all-levels
`msda_patch_v6` of `ops/msda_patch.py`): a block per (head, query tile,
item) computes each sample's corners once, stages only the windows of
cells that its head's corners fall in, and sums each query in one lane
group's registers. v2 is the walk in query order at the full width, with
the tile's row band (`v2_row_band`) written out; v3 the walk in a spatial
sort and `cw`-column chunks, with the tile's `v3_windows` written out: the
TPU's fit-or-full-width choice changes only what it stages, and the walk
stages only occupied windows either way. The host's `walk_plan` picks the
tile, the windows and the lanes of a launch; a head row of more than 32
words (float32 rows of more than 128 channels, bfloat16 rows that the
pointer's alignment splits finely) takes several passes of a warp.

All are differentiable: the backward of each is the backward kernel of
`ops/msda.py` launched for the single level, as the JAX package shares one
`_bwd`. On a CPU tensor all are the plain version `level_plain`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cuda_build import MSDA_COMMON, CudaLib
from .msda import count_launch, level_plain, msda_bwd_cuda, msda_cuda

# queries per tile of the plain bounds (the JAX package's V2_TQ), where the
# caller leaves `tq` unset
V2_TQ = 256
# kernel v3: columns of a tile's window (the JAX function's default)
V3_CW = 64


def dense_level_pallas(value_l: torch.Tensor, loc_l: torch.Tensor,
                       attn_l: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """value_l (N, H*W, M, D); loc_l (N, Lq, M, P, 2); attn_l (N, Lq, M, P)
    -> (N, Lq, M, D) in the value dtype (the TPU kernel returns float32)."""
    if value_l.shape[1] != h * w:
        raise ValueError(f"{value_l.shape[1]} cells for a {h}x{w} level")
    if value_l.device.type == "cpu":
        return level_plain(value_l, loc_l, attn_l, h, w).to(value_l.dtype)
    return msda_cuda(value_l, ((h, w),), loc_l.unsqueeze(3),
                     attn_l.unsqueeze(3), "dense_level_pallas")


# --------------------------------------------------------------------------
# the walk of kernels v2, v3, v4 and v6 (`csrc/msda_dense_v4_fwd.cu`): the
# host's plan
# --------------------------------------------------------------------------

# threads a block, and the SMs of the card the plan fills (H100 SXM)
WALK_THREADS = 256
WALK_SMS = 132
# the most queries one lane group owns: the kernel's instantiations; the
# tiles the plan takes, largest first
WALK_KMAX = (1, 2, 4, 8)
WALK_TQS = (192, 96, 48, 24)
# words of a head row in one pass of a lane group (a warp's lanes), and the
# most passes
WALK_PASS_WORDS = 32
WALK_MAX_PASSES = 32
# the most levels of one launch
WALK_MAX_LEVELS = 8
# shared memory for each of the walk's two stages, and a window's target
# size where the samples are dense (several windows a stage)
WALK_STAGE_BYTES = 16 * 1024
WALK_WINDOW_BYTES = 4 * 1024
# a window of whole rows at the full width: at most this many bytes (at
# least one row), one a stage
WALK_ROWS_BYTES = 24 * 1024
# the window where the samples are sparse (fewer corners a head than
# cells: the decoder's scattered queries), rows x columns, and its columns
# where they are dense
WALK_SPARSE_ROWS = 1
WALK_SPARSE_COLS = 4
WALK_DENSE_COLS = 16
WALK_SMEM_LIMIT = 227 * 1024


class WalkPlan(NamedTuple):
    """How the walk serves one level of a launch: `tq` queries a tile; lane
    groups of `lanes` lanes, each lane on `word` bytes of a head row,
    `passes` passes over a row, `groups` groups a block, each owning at most
    `kmax` queries of the tile; windows of `wr` rows x `wc` columns on a
    fixed grid of `nwin` windows, `wps` of them a stage of `stage_bytes`;
    `smem_bytes` of shared memory a block; the grid (heads, tiles,
    items)."""
    tq: int
    kmax: int
    word: int
    lanes: int
    passes: int
    groups: int
    wr: int
    wc: int
    wps: int
    nwin: int
    stage_bytes: int
    smem_bytes: int
    grid: Tuple[int, int, int]


def _largest_divisor(n: int, most: int) -> int:
    return max(k for k in range(1, min(n, most) + 1) if n % k == 0)


@functools.lru_cache(maxsize=256)
def walk_plan(n: int, lq: int, m: int, p: int, d: int, h: int, w: int,
              es: int, value_ptr: int, cw: int = 0,
              tq: Optional[int] = None,
              stage_budget: int = WALK_STAGE_BYTES,
              window_budget: int = WALK_WINDOW_BYTES) -> WalkPlan:
    """The plan of the walk (`csrc/msda_dense_v4_fwd.cu`) for one level of
    (h, w) cells with head rows of d elements of es bytes at `value_ptr`,
    `lq` queries of p points, walked in column chunks of `cw` (0: the full
    width). The word: the widest of 16, 8, 4, 2 bytes that divides a head's
    row, the cell and the pointer's alignment. The lanes: min(32, words);
    a row of more words takes ceil(words / 32) passes (float32 rows of
    more than 128 channels; bfloat16 rows of more than 32 channels at a
    pointer only 2-byte aligned, of more than 64 at a 4-byte one), one of
    more than 32 x 32 words is refused. The tile (`tq` None): the largest
    of `WALK_TQS` that the block's lane groups can own and that still gives
    two blocks an SM, else the smallest they can own. The windows, sized
    for a pass's slice of a head row: at the full width, whole rows
    (`WALK_ROWS_BYTES`); in chunks, a divisor of the chunk as columns (so
    that a window lies in one chunk):
    `WALK_SPARSE_ROWS` x `WALK_SPARSE_COLS` cells where the samples are
    sparse, about `window_budget` bytes of `WALK_DENSE_COLS` columns where
    they are dense; `stage_budget` bytes of windows a stage (the tests'
    mirror of the walk takes small budgets, so that a tile walks several
    stages). Only `value_ptr % 16` matters: the wrappers pass that, so
    that the cache holds one plan a call shape."""
    word = next(wd for wd in (16, 8, 4, 2)
                if wd >= es and (d * es) % wd == 0 and value_ptr % wd == 0)
    words = d * es // word
    if words > WALK_PASS_WORDS * WALK_MAX_PASSES:
        raise ValueError(f"walk: a head row of {words} words of {word} bytes "
                         f"({d} x {es} bytes at {value_ptr % 16} bytes past "
                         f"a 16-byte boundary), more than "
                         f"{WALK_PASS_WORDS * WALK_MAX_PASSES}")
    lanes = min(words, WALK_PASS_WORDS)
    passes = -(-words // WALK_PASS_WORDS)
    groups = WALK_THREADS // 32 * (32 // lanes)
    if tq is None:
        owned = [t for t in WALK_TQS if t <= groups * WALK_KMAX[-1]]
        tq = next((t for t in owned if m * -(-lq // t) * n >= 2 * WALK_SMS),
                  owned[-1])
    kmax = next((k for k in WALK_KMAX if groups * k >= tq), None)
    if kmax is None or tq < 1:
        raise ValueError(f"walk: tq {tq} above {groups * WALK_KMAX[-1]}")
    cell = lanes * word
    if cw == 0:
        wc = w
        wr = max(1, min(h, WALK_ROWS_BYTES // (w * cell)))
    elif lq * p < h * w:
        wc = _largest_divisor(min(cw, w), WALK_SPARSE_COLS)
        wr = min(WALK_SPARSE_ROWS, h)
    else:
        wc = _largest_divisor(min(cw, w), WALK_DENSE_COLS)
        wr = max(1, min(h, window_budget // (wc * cell)))
    wps = max(1, stage_budget // (wr * wc * cell))
    nwin = -(-h // wr) * -(-w // wc)
    while nwin + wps >= 32768:          # a corner's key holds its window
        wr *= 2
        wps = max(1, stage_budget // (wr * wc * cell))
        nwin = -(-h // wr) * -(-w // wc)
    stage_bytes = -(-wps * wr * wc * cell // 16) * 16
    smem = 2 * stage_bytes + 4 * (2 * tq * (4 * p + 1) + 2 * nwin + tq
                                  + 128 + 64)
    if smem > WALK_SMEM_LIMIT:
        raise ValueError(f"walk: {smem} bytes of shared memory a block")
    return WalkPlan(tq, kmax, word, lanes, passes, groups, wr, wc, wps, nwin,
                    stage_bytes, smem, (m, -(-lq // tq), n))


class LevelsPlan(NamedTuple):
    """How the walk serves a launch over several levels (the all-levels
    `msda_patch_v6`): the tile, lanes and grid shared by every level, and
    each level's own `walk_plan` at that tile (its windows: wr, wc, wps,
    nwin, stage_bytes) with its first cell `start` in an item's value
    table; `smem_bytes` a block, the largest level's stage and windows
    reused from level to level; `table`, the C entry point's level table
    (h, w, wr, wc, wps a level)."""
    tq: int
    kmax: int
    word: int
    lanes: int
    passes: int
    groups: int
    shapes: Tuple[Tuple[int, int], ...]
    starts: Tuple[int, ...]
    levels: Tuple[WalkPlan, ...]
    smem_bytes: int
    grid: Tuple[int, int, int]
    table: Tuple[int, ...]


@functools.lru_cache(maxsize=64)
def levels_plan(n: int, lq: int, m: int, p: int, d: int, shapes,
                es: int, value_ptr: int, cw: int = V3_CW,
                tq: Optional[int] = None,
                stage_budget: int = WALK_STAGE_BYTES,
                window_budget: int = WALK_WINDOW_BYTES) -> LevelsPlan:
    """The plan of one walk over the levels `shapes` ((h, w), ...) in
    `cw`-column chunks: level 0's `walk_plan` picks the tile (`tq` None),
    every level's `walk_plan` at that tile its windows. Each level's
    `nwin + wps` stays under 32768 (a corner's key); the block's shared
    memory, the largest stage and window table, within the card's."""
    shapes = tuple(tuple(hw) for hw in shapes)
    if not 1 <= len(shapes) <= WALK_MAX_LEVELS:
        raise ValueError(f"walk: {len(shapes)} levels")
    first = walk_plan(n, lq, m, p, d, *shapes[0], es, value_ptr, cw, tq,
                      stage_budget, window_budget)
    levels = tuple(walk_plan(n, lq, m, p, d, h, w, es, value_ptr, cw,
                             first.tq, stage_budget, window_budget)
                   for h, w in shapes)
    starts = tuple(int(x) for x in np.cumsum([0] + [h * w for h, w
                                                   in shapes[:-1]]))
    stage = max(pl.stage_bytes for pl in levels)
    nwin = max(pl.nwin for pl in levels)
    smem = 2 * stage + 4 * (2 * first.tq * (4 * p + 1) + 2 * nwin + first.tq
                            + 128 + 64)
    if smem > WALK_SMEM_LIMIT:
        raise ValueError(f"walk: {smem} bytes of shared memory a block")
    table = tuple(v for (h, w), pl in zip(shapes, levels)
                  for v in (h, w, pl.wr, pl.wc, pl.wps))
    return LevelsPlan(first.tq, first.kmax, first.word, first.lanes,
                      first.passes, first.groups, shapes, starts, levels,
                      smem, first.grid, table)


@functools.lru_cache(maxsize=64)
def _c_ints(values: Tuple[int, ...]):
    """`values` as a C int array, made once a plan (a launch's host work
    is most of a small call's time)."""
    return (ctypes.c_int * len(values))(*values)


V4_LIB = CudaLib("msda_dense_v4_fwd.cu", {"msda_walk_fwd": (
    ctypes.c_int,
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p])}, headers=[MSDA_COMMON])


def launch_walk(value, loc, attn, plan: LevelsPlan, cw: int,
                perm: Optional[torch.Tensor] = None,
                perm_shared: Optional[torch.Tensor] = None,
                bounds: Optional[torch.Tensor] = None,
                bounds_kind: Optional[str] = None) -> torch.Tensor:
    """One launch of the walk's C entry point `msda_walk_fwd` as `plan`
    says, on checked inputs: value (N, cells, M, D), loc (N, Lq, M, L, P,
    2) or (N, Lq, M, P, 2) for one level, attn likewise; the tiles' order
    `perm` (N, Lq) int64 or `perm_shared` (Lq) int32; a one-level launch
    may fill `bounds` with the tiles' "ranges", "band" or "windows". ->
    out (N, Lq, M, D) float32. Raises if the launch fails; counts
    nothing."""
    n, lq, m = loc.shape[:3]
    d = value.shape[-1]
    lib = V4_LIB.load()
    out = torch.empty(n, lq, m, d, dtype=torch.float32, device=value.device)
    b = None if bounds is None else bounds.data_ptr()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_walk_fwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
            None if perm is None else perm.data_ptr(),
            None if perm_shared is None else perm_shared.data_ptr(),
            out.data_ptr(), b if bounds_kind == "ranges" else None,
            b if bounds_kind == "band" else None,
            b if bounds_kind == "windows" else None,
            n, lq, m, attn.shape[-1], d, int(value.dtype == torch.bfloat16),
            len(plan.shapes), _c_ints(plan.table), cw, plan.tq, plan.kmax,
            plan.word, stream)
    if rc != 0:
        raise RuntimeError(f"msda_walk_fwd launch failed: cudaError {rc}")
    return out


def _walk(count_name: str, value_l, loc_l, attn_l, h: int, w: int,
          perm: Optional[torch.Tensor], cw: int, tq: Optional[int],
          bounds_kind: Optional[str] = None):
    """One launch of the walk over one level, served as `walk_plan` says ->
    (out (N, Lq, M, D) float32, the tiles' int32 `bounds_kind` bounds:
    "ranges" or "windows" (N, tiles, 4), "band" (N, tiles, 2); None where
    not asked for). Counts it as `count_name`."""
    n, lq, m, p, d = _check_level_inputs("msda_walk_fwd", value_l, loc_l,
                                         attn_l, h, w)
    plan = levels_plan(n, lq, m, p, d, ((h, w),), value_l.element_size(),
                       value_l.data_ptr() % 16, cw, tq)
    bounds = (torch.empty(n, plan.grid[1], 2 if bounds_kind == "band" else 4,
                          dtype=torch.int32, device=value_l.device)
              if bounds_kind else None)
    out = launch_walk(value_l, loc_l, attn_l, plan, cw, perm=perm,
                      bounds=bounds, bounds_kind=bounds_kind)
    count_launch(count_name, n, lq, ((h, w),))
    return out, bounds


# --------------------------------------------------------------------------
# block-skipping level (TPU kernel v2)
# --------------------------------------------------------------------------

def v2_row_band(loc_l: torch.Tensor, h: int, tq: int = V2_TQ) -> torch.Tensor:
    """Plain version of the skip bound: loc_l (N, Lq, M, P, 2) ->
    (N, ceil(Lq / tq), 2) int64, each tile's inclusive range of value rows
    `floor(min y) - 1 .. floor(max y) + 1` over the tile's queries, heads
    and points (y = loc_y * h - 0.5), not clipped to the level. Rows outside
    it carry no weight for the tile."""
    n, lq = loc_l.shape[:2]
    y = (loc_l[..., 1].float() * h - 0.5).reshape(n, lq, -1)
    n_q = -(-lq // tq)
    pad = n_q * tq - lq
    inf = float("inf")
    lo = torch.nn.functional.pad(y, (0, 0, 0, pad), value=inf)
    hi = torch.nn.functional.pad(y, (0, 0, 0, pad), value=-inf)
    lo = torch.floor(lo.reshape(n, n_q, -1).amin(-1)) - 1
    hi = torch.floor(hi.reshape(n, n_q, -1).amax(-1)) + 1
    return torch.stack([lo, hi], -1).long()


def _check_level_inputs(name: str, value_l, loc_l, attn_l, h: int, w: int):
    """What every per-level kernel takes: CUDA tensors on one device,
    value float32 or bfloat16, locations and weights float32, shapes of one
    (h, w) level, contiguous. -> (n, lq, m, p, d)."""
    if not (value_l.is_cuda and loc_l.is_cuda and attn_l.is_cuda):
        raise ValueError(f"{name}: all inputs must be CUDA tensors")
    if not (value_l.device == loc_l.device == attn_l.device):
        raise ValueError(f"{name}: inputs on different devices")
    if value_l.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: value dtype {value_l.dtype}")
    if loc_l.dtype != torch.float32 or attn_l.dtype != torch.float32:
        raise TypeError(f"{name}: locations and weights must be float32")
    n, cells, m, d = value_l.shape
    if cells != h * w:
        raise ValueError(f"{name}: {cells} cells for a {h}x{w} level")
    lq, p = loc_l.shape[1], loc_l.shape[3]
    if tuple(loc_l.shape) != (n, lq, m, p, 2) \
            or tuple(attn_l.shape) != (n, lq, m, p):
        raise ValueError(f"{name}: loc {tuple(loc_l.shape)}, "
                         f"attn {tuple(attn_l.shape)}")
    if not (value_l.is_contiguous() and loc_l.is_contiguous()
            and attn_l.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    return n, lq, m, p, d


def _check_perm(name: str, perm, ref: torch.Tensor) -> None:
    n, lq = ref.shape[:2]
    if perm.dtype != torch.int64 or tuple(perm.shape) != (n, lq) \
            or perm.device != ref.device or not perm.is_contiguous():
        raise ValueError(f"{name}: perm must be a contiguous int64 "
                         f"({n}, {lq}) tensor on {ref.device}")


def dense_level_v2_fwd_cuda(value_l: torch.Tensor, loc_l: torch.Tensor,
                            attn_l: torch.Tensor, h: int, w: int,
                            tq: Optional[int] = None,
                            return_band: bool = False):
    """One launch of the block-skipping kernel: the walk (`V4_LIB`) at the
    full width in query order, served as `walk_plan` says (`tq` None: the
    plan's tile) -> (N, Lq, M, D) float32; with `return_band` also the
    kernel's own (N, ceil(Lq / tq), 2) int32 row bands clipped to the level
    (lo > hi: empty). Counts the launch as "dense_level_pallas_v2"."""
    out, band = _walk("dense_level_pallas_v2", value_l, loc_l, attn_l, h, w,
                      None, 0, tq, "band" if return_band else None)
    return (out, band) if return_band else out


class DenseLevelFunction(torch.autograd.Function):
    """A per-level forward launcher `launch(value_l, loc_l, attn_l, h, w)`
    with the shared MSDA backward kernel, launched for the single level, as
    its gradient."""

    @staticmethod
    def forward(ctx, value_l, loc_l, attn_l, h, w, launch):
        out = launch(value_l, loc_l, attn_l, h, w)
        ctx.save_for_backward(value_l, loc_l, attn_l)
        ctx.hw = (h, w)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value_l, loc_l, attn_l = ctx.saved_tensors
        gv, gl, ga = msda_bwd_cuda(grad_out, value_l, (ctx.hw,),
                                   loc_l.unsqueeze(3), attn_l.unsqueeze(3))
        return gv, gl.squeeze(3), ga.squeeze(3), None, None, None


def _level_op(launch, value_l, loc_l, attn_l, h: int, w: int) -> torch.Tensor:
    """A per-level op: the plain version on CPU tensors, else `launch` with
    its gradient -> (N, Lq, M, D) float32."""
    if value_l.shape[1] != h * w:
        raise ValueError(f"{value_l.shape[1]} cells for a {h}x{w} level")
    if value_l.device.type == "cpu":
        return level_plain(value_l, loc_l, attn_l, h, w)
    return DenseLevelFunction.apply(value_l.contiguous(), loc_l.contiguous(),
                                    attn_l.contiguous(), h, w, launch)


def dense_level_pallas_v2(value_l: torch.Tensor, loc_l: torch.Tensor,
                          attn_l: torch.Tensor, h: int, w: int
                          ) -> torch.Tensor:
    """Block-skipping variant of `dense_level_pallas`, same semantics:
    value_l (N, H*W, M, D); loc_l (N, Lq, M, P, 2); attn_l (N, Lq, M, P)
    -> (N, Lq, M, D) float32, as the TPU kernel returns it."""
    return _level_op(dense_level_v2_fwd_cuda, value_l, loc_l, attn_l, h, w)


# --------------------------------------------------------------------------
# range-walking level (TPU kernel v4) and its sorted variant (v4p)
# --------------------------------------------------------------------------

def spatial_sort_perm(loc_all: torch.Tensor, h: int, w: int,
                      bucket: int = 8) -> torch.Tensor:
    """Permutation (N, Lq) int64 that sorts the queries by their mean sample
    position on a raster of `bucket` x `bucket`-cell tiles of an (h, w)
    level. loc_all (N, Lq, M, P, 2) in [0, 1] at any level: locality in the
    image is the same at every level. The sort is stable, as the JAX
    package's is, so ties keep the queries' order."""
    xm = (loc_all[..., 0].float().mean((2, 3)) * w).clamp(0, w - 1)
    ym = (loc_all[..., 1].float().mean((2, 3)) * h).clamp(0, h - 1)
    ntx = -(-w // bucket)
    key = (ym.to(torch.int32) // bucket) * ntx + xm.to(torch.int32) // bucket
    return torch.argsort(key, dim=1, stable=True)


def _tile_min_max(loc_l: torch.Tensor, h: int, w: int, tq: int,
                  perm: Optional[torch.Tensor]):
    """Per tile of `tq` queries (in `perm` order) the min and max of the
    samples' cell coordinates over queries, heads and points:
    (xmin, xmax, ymin, ymax), each (N, ceil(Lq / tq)). Queries past Lq are
    left out, not padded."""
    n, lq = loc_l.shape[:2]
    if perm is not None:
        loc_l = torch.take_along_dim(
            loc_l, perm.long()[:, :, None, None, None], 1)
    n_q = -(-lq // tq)
    pad = (0, 0, 0, n_q * tq - lq)
    out = []
    for axis, size in ((0, w), (1, h)):
        c = (loc_l[..., axis].float() * size - 0.5).reshape(n, lq, -1)
        lo = torch.nn.functional.pad(c, pad, value=float("inf"))
        hi = torch.nn.functional.pad(c, pad, value=-float("inf"))
        out += [lo.reshape(n, n_q, -1).amin(-1),
                hi.reshape(n, n_q, -1).amax(-1)]
    return out


def v4_ranges(loc_l: torch.Tensor, h: int, w: int, tq: Optional[int] = None,
              cw: Optional[int] = None,
              perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel v4's walk bounds: loc_l (N, Lq, M, P, 2) ->
    (N, ceil(Lq / tq), 4) int64, each tile's inclusive [row lo, row hi,
    column lo, column hi] in cells, clipped as the JAX ranges are: rows
    `floor(min y) - 1 .. floor(max y) + 1` into [0, h - 1] (hi down to -1:
    a tile wholly above the level walks nothing, lo > hi), columns
    `floor(min x) .. floor(max x) + 1` into [0, w - 1]. A tile wholly below
    or beside the level walks one clipped row or column that carries no
    weight. With `cw` None the walk takes every row at full width, so the
    columns are (0, w - 1). Chunk c of a walk owns the columns
    [c * cw, (c + 1) * cw)."""
    tq = V2_TQ if tq is None else tq
    xmin, xmax, ymin, ymax = _tile_min_max(loc_l, h, w, tq, perm)
    r_lo = (torch.floor(ymin) - 1).clamp(0, h - 1)
    r_hi = (torch.floor(ymax) + 1).clamp(-1, h - 1)
    c_lo = torch.floor(xmin).clamp(0, w - 1)
    c_hi = (torch.floor(xmax) + 1).clamp(0, w - 1)
    if cw is None:
        c_lo, c_hi = torch.zeros_like(c_lo), torch.full_like(c_hi, w - 1)
    return torch.stack([r_lo, r_hi, c_lo, c_hi], -1).long()




def dense_level_v4_fwd_cuda(value_l: torch.Tensor, loc_l: torch.Tensor,
                            attn_l: torch.Tensor, h: int, w: int,
                            perm: Optional[torch.Tensor] = None,
                            cw: Optional[int] = None,
                            tq: Optional[int] = None,
                            return_ranges: bool = False):
    """One launch of the range-walking kernel, served as `walk_plan` says
    (`tq` None: the plan's tile) -> (N, Lq, M, D) float32; with
    `return_ranges` also the kernel's own (N, ceil(Lq / tq), 4) int32 walk
    bounds (`v4_ranges` at that tile). `perm` (N, Lq) int64 tiles the
    queries in its order; `cw` None walks every row at full width. Counts
    the launch as "dense_level_pallas_v4"."""
    if perm is not None:
        _check_perm("msda_walk_fwd", perm, loc_l)
    if cw is not None and cw < 1:
        raise ValueError(f"msda_walk_fwd: cw {cw}")
    out, ranges = _walk("dense_level_pallas_v4", value_l, loc_l, attn_l, h,
                        w, perm, cw or 0, tq,
                        "ranges" if return_ranges else None)
    return (out, ranges) if return_ranges else out


def dense_level_pallas_v4(value_l: torch.Tensor, loc_l: torch.Tensor,
                          attn_l: torch.Tensor, h: int, w: int
                          ) -> torch.Tensor:
    """Range-walking variant of `dense_level_pallas_v2`, same semantics and
    shapes: tiles of consecutive queries, each walking its own row range at
    full width -> (N, Lq, M, D) float32."""
    return _level_op(dense_level_v4_fwd_cuda, value_l, loc_l, attn_l, h, w)


def dense_level_pallas_v4p(value_l: torch.Tensor, loc_l: torch.Tensor,
                           attn_l: torch.Tensor, perm: torch.Tensor, h: int,
                           w: int, cw: Optional[int]) -> torch.Tensor:
    """`dense_level_pallas_v4` with the caller's sort permutation `perm`
    (N, Lq) int64 and chunk width `cw` in columns: lets `ms_deform_attn`
    take one spatial sort per call for all its levels. `perm` is integer
    data and gets no gradient."""
    if tuple(perm.shape) != tuple(loc_l.shape[:2]):
        raise ValueError(f"perm {tuple(perm.shape)} for queries "
                         f"{tuple(loc_l.shape[:2])}")
    return _level_op(functools.partial(dense_level_v4_fwd_cuda,
                                       perm=perm.contiguous(), cw=cw),
                     value_l, loc_l, attn_l, h, w)


# --------------------------------------------------------------------------
# sorted, x-windowed level (TPU kernel v3)
# --------------------------------------------------------------------------

def v3_windows(loc_l: torch.Tensor, h: int, w: int, perm: torch.Tensor,
               tq: Optional[int] = None, cw: int = V3_CW) -> torch.Tensor:
    """Plain version of kernel v3's bounds: loc_l (N, Lq, M, P, 2), tiled in
    `perm` order -> (N, ceil(Lq / tq), 4) int64, each tile's [row lo, row
    hi, xstart, fits]: the row band `floor(min y) - 1 .. floor(max y) + 1`
    clipped to the level (lo > hi: empty); `fits` when the occupied columns
    `max(0, floor(min x)) .. min(w - 1, floor(max x) + 1)` span at most
    `cw` (clipped to w) columns, and then the window starts at
    `xstart = min(left, w - cw)`; else the tile takes the full width and
    xstart is 0."""
    tq = V2_TQ if tq is None else tq
    cw = min(cw, w)
    xmin, xmax, ymin, ymax = _tile_min_max(loc_l, h, w, tq, perm)
    r_lo = (torch.floor(ymin) - 1).clamp(0, h)
    r_hi = (torch.floor(ymax) + 1).clamp(-1, h - 1)
    left = torch.floor(xmin).clamp(0, w + 1)
    right = (torch.floor(xmax) + 1).clamp(-1, w - 1)
    fits = right - left + 1 <= cw
    xstart = torch.where(fits, left.clamp(max=w - cw), torch.zeros_like(left))
    return torch.stack([r_lo, r_hi, xstart, fits.to(r_lo.dtype)], -1).long()


def dense_level_v3_fwd_cuda(value_l: torch.Tensor, loc_l: torch.Tensor,
                            attn_l: torch.Tensor, h: int, w: int,
                            perm: Optional[torch.Tensor] = None,
                            cw: int = V3_CW, tq: Optional[int] = None,
                            return_windows: bool = False):
    """One launch of the sorted, x-windowed kernel: the walk (`V4_LIB`) in
    `perm` order and `cw`-column chunks, served as `walk_plan` says (`tq`
    None: the plan's tile) -> (N, Lq, M, D) float32; with `return_windows`
    also the kernel's own (N, ceil(Lq / tq), 4) int32 bounds (`v3_windows`
    at that tile). `perm` None: the queries' own spatial sort. Counts the
    launch as "dense_level_pallas_v3"."""
    name = "msda_walk_fwd"
    _check_level_inputs(name, value_l, loc_l, attn_l, h, w)
    if perm is None:
        perm = spatial_sort_perm(loc_l, h, w)
    _check_perm(name, perm, loc_l)
    if cw < 1:
        raise ValueError(f"{name}: cw {cw}")
    out, windows = _walk("dense_level_pallas_v3", value_l, loc_l, attn_l, h,
                         w, perm, cw, tq,
                         "windows" if return_windows else None)
    return (out, windows) if return_windows else out


def dense_level_pallas_v3(value_l: torch.Tensor, loc_l: torch.Tensor,
                          attn_l: torch.Tensor, h: int, w: int,
                          perm: Optional[torch.Tensor] = None,
                          cw: int = V3_CW) -> torch.Tensor:
    """Sorted and x-windowed variant of `dense_level_pallas_v2`, same
    semantics and shapes -> (N, Lq, M, D) float32. `perm` (N, Lq) int64
    replaces the queries' own spatial sort."""
    return _level_op(functools.partial(dense_level_v3_fwd_cuda, perm=perm,
                                       cw=cw),
                     value_l, loc_l, attn_l, h, w)
