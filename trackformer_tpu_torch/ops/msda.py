"""Multi-scale deformable attention (MSDA): the op, its plain PyTorch
version and the binding of its CUDA kernel.

Counterpart of `trackformer_tpu/ops/msda.py`. The contract is the same as
`ms_deform_attn` there:

  value:              (N, S, M, D)   S = sum_l H_l * W_l
  spatial_shapes:     tuple ((H_0, W_0), ..., (H_{L-1}, W_{L-1}))
  sampling_locations: (N, Lq, M, L, P, 2) in [0, 1] as (x, y), float32
  attention_weights:  (N, Lq, M, L, P), float32
  -> output:          (N, Lq, M * D) in the value dtype

Every level is sampled bilinearly with grid_sample semantics
(align_corners=False, zero padding) and reduced with the attention weights.

On a CUDA tensor, with the default route, the op is ONE launch of the
kernel in `csrc/msda_fwd.cu` over all levels of the call, a warp per (item,
query, head) with the row word and block size of the host's plan
`fwd_plan`: the encoder's self-pattern (Lq == S) goes through `msda_patch`,
every other call through the launch here. That covers what the TPU
package splits over its v5 patch kernel, its v1 dense kernel and its XLA
dense and gather paths, a routing that exists there only for the TPU's
missing gather. On a CPU tensor the op runs the plain version
`ms_deform_attn_plain`. Nothing falls back from a kernel to the plain
version.

The route switches are the JAX package's. The module global
`PALLAS_SKIP_IMPL`, read from the environment variable of that name, default
"v5": with "v2" the levels that the JAX routing sends to its block-skipping
kernel (`v2_levels`) go through `dense_level_pallas_v2`
(`ops/msda_dense.py`: the walk of `csrc/msda_dense_v4_fwd.cu` at the full
width in query order); with "v4" the same levels go through the
range-walking kernel (the same walk, `csrc/msda_dense_v4_fwd.cu`):
`dense_level_pallas_v4p` in column chunks of `PALLAS_V4_CW` with ONE
spatial sort of the queries per call while `PALLAS_V4_SORT` is on, else
`dense_level_pallas_v4`. The module global `MSDA_DEC_SKIP` (environment
variable, default off) sends the fine levels of a call with few queries, the
decoder's (`dec_skip_levels`), through `dense_level_pallas_v4p` likewise.
Either way it is one launch per such level, and the other levels of the
call go through one launch of the gather kernel; a call with no such level
takes the default route.

The op is differentiable: on the card `MSDAFunction` pairs the forward
launch with the backward kernel in `csrc/msda_bwd.cu`, which returns the
gradients of value, locations and weights in one launch over all levels,
split as the host's plan `bwd_plan` says (which levels each block sums in
shared memory, queries per block); its float32 atomics make the value
gradient differ in its last bits from run to run. On a CPU tensor
autograd differentiates the plain version.
Kernels are built at first use (`cuda_build.py`).
"""
from __future__ import annotations

import ctypes
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .cuda_build import MSDA_COMMON, CudaLib

# which kernel serves the levels of a call (module docstring); read at every
# call, so a caller may set it between calls
PALLAS_SKIP_IMPL = os.environ.get("PALLAS_SKIP_IMPL", "v5")
# route "v4": columns per chunk of the walk, and whether the queries of a
# call are sorted spatially first (one permutation for all its levels)
PALLAS_V4_CW = 64
PALLAS_V4_SORT = True
# the decoder's fine levels through the range-walking kernel (off: the
# gather kernel serves all levels of a decoder call in one launch)
MSDA_DEC_SKIP = os.environ.get("MSDA_DEC_SKIP", "0") == "1"
# the JAX routing's constants (`trackformer_tpu/ops/msda.py`): a level whose
# N*Lq*M*H*W is within the budget runs there as a dense XLA product; a level
# over it, of at most PALLAS_V2_MAX_CELLS cells and queried by at least
# PALLAS_V2_MIN_QUERIES queries, is a "v2 level"; with fewer queries, a
# level over the budget of more than PALLAS_DENSE_MAX_CELLS (the JAX v1
# kernel's limit) and at most PALLAS_V2_MAX_CELLS cells is a "dec-skip level"
DENSE_CELL_BUDGET = 8_000_000
PALLAS_DENSE_MAX_CELLS = 8192
PALLAS_V2_MAX_CELLS = 32768
PALLAS_V2_MIN_QUERIES = 4096


# Launches of the kernel by wrapper: the port's only global state. They
# show that a run went through the kernel; each wrapper adds one where it
# launches and nowhere else.
LAUNCHES: Dict[str, int] = {"ms_deform_attn": 0, "msda_patch": 0,
                            "dense_level_pallas": 0,
                            "dense_level_pallas_v2": 0, "msda_bwd": 0,
                            "dense_level_pallas_v4": 0,
                            "dense_level_pallas_v3": 0,
                            "ms_deform_attn_pallas": 0,
                            "ms_deform_attn_pallas_corners": 0,
                            "msda_patch_v6": 0}
# The same launches by shape, (count name, items, queries per item, levels)
# and, where the wrapper gives it, the channels of a head (the gather
# kernel and the backward: 36 at hidden 288, 32 at hidden 256): they show
# which shapes a run gave each kernel, the backward's split over the
# encoder's and the decoder's calls included.
LAUNCH_SHAPES: Dict[tuple, int] = {}


def count_launch(name: str, n: int, lq: int, spatial_shapes,
                 channels: Optional[int] = None) -> None:
    """Adds one launch to `name`; called where a kernel was launched."""
    LAUNCHES[name] += 1
    key = (name, n, lq, tuple(tuple(hw) for hw in spatial_shapes))
    if channels is not None:
        key += (channels,)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def launch_shapes() -> Dict[tuple, int]:
    return dict(LAUNCH_SHAPES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCH_SHAPES.clear()


# --------------------------------------------------------------------------
# plain version (CPU tensors, tests, and the reference on the card)
# --------------------------------------------------------------------------

def level_plain(value_l: torch.Tensor, loc_l: torch.Tensor,
                attn_l: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """One level's contribution: value_l (N, H*W, M, D); loc_l
    (N, Lq, M, P, 2); attn_l (N, Lq, M, P) -> (N, Lq, M, D) float32."""
    n, _, m, d = value_l.shape
    lq, p = loc_l.shape[1], loc_l.shape[3]
    x = loc_l[..., 0].float() * w - 0.5
    y = loc_l[..., 1].float() * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx, dy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    idx_c, w_c = [], []
    for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ix, iy = x0i + cx, y0i + cy
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx_c.append(iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))
        wx = dx if cx else 1.0 - dx
        wy = dy if cy else 1.0 - dy
        w_c.append(wx * wy * valid * attn_l.float())
    idx = torch.stack(idx_c, -1)                       # (N, Lq, M, P, 4)
    wgt = torch.stack(w_c, -1)
    table = value_l.float().permute(0, 2, 1, 3)        # (N, M, HW, D)
    idx = idx.permute(0, 2, 1, 3, 4).reshape(n, m, lq * p * 4)
    g = torch.gather(table, 2, idx[..., None].expand(-1, -1, -1, d))
    g = g.reshape(n, m, lq, p * 4, d)
    wgt = wgt.permute(0, 2, 1, 3, 4).reshape(n, m, lq, p * 4, 1)
    return (g * wgt).sum(3).permute(0, 2, 1, 3)


def ms_deform_attn_plain(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch MSDA (port of `ms_deform_attn_reference`):
    -> (N, Lq, M, D) float32."""
    n, s, m, d = value.shape
    lq = sampling_locations.shape[1]
    out = torch.zeros(n, lq, m, d, dtype=torch.float32, device=value.device)
    offset = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        out = out + level_plain(value[:, offset:offset + h * w],
                                sampling_locations[:, :, :, lvl],
                                attention_weights[:, :, :, lvl], h, w)
        offset += h * w
    return out


# --------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# --------------------------------------------------------------------------

LIB = CudaLib("msda_fwd.cu", {"msda_fwd": (
    ctypes.c_int,
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7
    + [ctypes.c_void_p])}, headers=[MSDA_COMMON])
# the forward kernel's warps a block (`fwd_plan`), each on one (item,
# query, head): 2 and 4 ran within 4 % of each other on every flagship
# call, 8 up to 12 % slower (`chip_smoke.py --phases msda --old-msda-fwd`,
# `ms_by_warps`); the decoder call at B = 1 is then 1,304 blocks for the
# H100's 132 SMs
FWD_WARPS = 4


class FwdPlan(NamedTuple):
    """How the forward kernel serves one call: `word`, the bytes a lane
    loads of a head's row at a time (16 or 8; 0: one channel a lane), and
    `warps` per block, each on one (item, query, head); the launch grid
    as (query tiles, heads, items) in `grid`: warp w of block (x, head,
    item) serves query x * warps + w. The kernel is launched on `grid`,
    and its entry point refuses a grid that misses a query."""
    word: int
    warps: int
    grid: Tuple[int, int, int]


def fwd_plan(n: int, lq: int, m: int, d: int, es: int, value_ptr: int,
             warps: int = FWD_WARPS) -> FwdPlan:
    """The plan of the forward kernel for a call (`csrc/msda_fwd.cu`) with
    head rows of d elements of es bytes at `value_ptr`: the widest word of
    16 or 8 bytes that divides a head's row and the pointer's alignment,
    else one channel a lane; `warps` warps a block."""
    word = next((w for w in (16, 8)
                 if (d * es) % w == 0 and value_ptr % w == 0), 0)
    return FwdPlan(word, warps, (-(-lq // warps), m, n))


def _check_inputs(value, spatial_shapes, loc, attn):
    if not (value.is_cuda and loc.is_cuda and attn.is_cuda):
        raise ValueError("msda_fwd: all inputs must be CUDA tensors")
    if not (value.device == loc.device == attn.device):
        raise ValueError("msda_fwd: inputs on different devices")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"msda_fwd: value dtype {value.dtype}")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("msda_fwd: locations and weights must be float32")
    n, s, m, d = value.shape
    if loc.shape[:3] != (n, loc.shape[1], m) or loc.shape[-1] != 2:
        raise ValueError(f"msda_fwd: loc shape {tuple(loc.shape)}")
    lq, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    if tuple(attn.shape) != (n, lq, m, l, p):
        raise ValueError(f"msda_fwd: attn shape {tuple(attn.shape)}")
    if l != len(spatial_shapes) or s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"msda_fwd: {s} tokens do not match the levels "
                         f"{tuple(spatial_shapes)}")
    if not (value.is_contiguous() and loc.is_contiguous()
            and attn.is_contiguous()):
        raise ValueError("msda_fwd: inputs must be contiguous")


def msda_fwd_cuda(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor,
                  wrapper: str, out_f32: bool = False) -> torch.Tensor:
    """One launch of the CUDA kernel over the given levels, served as
    `fwd_plan` says -> (N, Lq, M, D) in the value dtype, or with `out_f32`
    the kernel's float32 sums unrounded. Counts the launch for
    `wrapper`."""
    _check_inputs(value, spatial_shapes, sampling_locations,
                  attention_weights)
    lib = LIB.load()
    n, s, m, d = value.shape
    _, lq, _, l, p, _ = sampling_locations.shape
    plan = fwd_plan(n, lq, m, d, value.element_size(), value.data_ptr())
    out = torch.empty(n, lq, m, d, device=value.device,
                      dtype=torch.float32 if out_f32 else value.dtype)
    shapes = (ctypes.c_int * (2 * l))(*[int(v) for hw in spatial_shapes
                                        for v in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_fwd(value.data_ptr(), sampling_locations.data_ptr(),
                          attention_weights.data_ptr(), out.data_ptr(),
                          n, s, lq, m, l, p, d, shapes,
                          int(value.dtype == torch.bfloat16), int(out_f32),
                          plan.word, plan.warps, *plan.grid, stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd launch failed: cudaError {rc}")
    count_launch(wrapper, n, lq, spatial_shapes, d)
    return out


BWD_LIB = CudaLib("msda_bwd.cu", {"msda_bwd": (
    ctypes.c_int,
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7
    + [ctypes.c_void_p])}, headers=[MSDA_COMMON])
# the backward kernel's plan (`bwd_plan`): the dynamic shared memory a
# block may use on Hopper (227 KB), the H100's SMs, the blocks per SM a call
# is cut into, the corner terms per cell that a block must expect on a level
# for it to sum the level in shared memory; and the threads of its blocks
BWD_SMEM_BYTES = 232_448
BWD_SMS = 132
BWD_WAVES = 4
BWD_MIN_HITS = 2
BWD_THREADS = 1024


class BwdPlan(NamedTuple):
    """How the backward kernel splits one call: `levels` summed in shared
    memory, `queries` per block, `smem_bytes` of their float32 head slices
    laid end to end, `vector` 16-byte reductions (D % 4 == 0)."""
    levels: Tuple[int, ...]
    queries: int
    smem_bytes: int
    vector: bool


def bwd_queries(n: int, lq: int, m: int, waves: int) -> int:
    """Queries per block of the backward kernel for about `waves` blocks
    per SM over a call of n * m (item, head) pairs."""
    return max(1, -(-lq // max(1, round(waves * BWD_SMS / (n * m)))))


def bwd_plan(n: int, lq: int, m: int, p: int, d: int,
             spatial_shapes: Sequence[Tuple[int, int]]) -> BwdPlan:
    """The plan of the backward kernel for a call (`csrc/msda_bwd.cu`). A
    block serves one (item, head) and a run of queries, the runs cut for
    about BWD_WAVES blocks per SM over the call: the blocks in flight at a
    time then cover a few heads, whose value-gradient rows stay in the L2
    cache while the blocks reduce into them. From the smallest level up, a
    level is summed in the block's shared memory while its head slice
    (H*W*D float32) still fits the budget and the block's samples put at
    least BWD_MIN_HITS corner terms on each of its cells on average. A call
    whose every level is summed there reduces nothing else into global
    memory and takes one wave of larger blocks, each with more hits per
    cell."""
    q = bwd_queries(n, lq, m, BWD_WAVES)
    levels, used = [], 0
    for i in sorted(range(len(spatial_shapes)),
                    key=lambda i: spatial_shapes[i][0] * spatial_shapes[i][1]):
        cells = spatial_shapes[i][0] * spatial_shapes[i][1]
        size = cells * d * 4
        if used + size > BWD_SMEM_BYTES or q * p * 4 < BWD_MIN_HITS * cells:
            break           # every later level is larger
        levels.append(i)
        used += size
    if len(levels) == len(spatial_shapes):
        q = bwd_queries(n, lq, m, 1)
    return BwdPlan(tuple(sorted(levels)), q, used, d % 4 == 0)


def msda_bwd_cuda(grad_out: torch.Tensor, value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor):
    """One launch of the backward kernel over the given levels, split as
    `bwd_plan` says. grad_out (N, Lq, M, D) float32 or bfloat16 ->
    (grad_value in the value dtype, grad_locations, grad_weights float32).
    Counts the launch as "msda_bwd"."""
    _check_inputs(value, spatial_shapes, sampling_locations,
                  attention_weights)
    n, s, m, d = value.shape
    _, lq, _, l, p, _ = sampling_locations.shape
    if grad_out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"msda_bwd: grad dtype {grad_out.dtype}")
    if grad_out.device != value.device or grad_out.numel() != n * lq * m * d:
        raise ValueError(f"msda_bwd: grad shape {tuple(grad_out.shape)} on "
                         f"{grad_out.device}")
    grad_out = grad_out.contiguous()
    lib = BWD_LIB.load()
    plan = bwd_plan(n, lq, m, p, d, spatial_shapes)
    # the 16-byte path loads 4 channels at a time from value and grad_out
    vector = plan.vector and all(t.data_ptr() % (4 * t.element_size()) == 0
                                 for t in (value, grad_out))
    grad_value = torch.zeros(n, s, m, d, dtype=torch.float32,
                             device=value.device)
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    shapes = (ctypes.c_int * (2 * l))(*[int(v) for hw in spatial_shapes
                                        for v in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_bwd(grad_out.data_ptr(), value.data_ptr(),
                          sampling_locations.data_ptr(),
                          attention_weights.data_ptr(), grad_value.data_ptr(),
                          grad_loc.data_ptr(), grad_attn.data_ptr(),
                          n, s, lq, m, l, p, d, shapes,
                          int(value.dtype == torch.bfloat16),
                          int(grad_out.dtype == torch.bfloat16),
                          sum(1 << i for i in plan.levels), plan.queries,
                          plan.smem_bytes, int(vector), BWD_THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"msda_bwd launch failed: cudaError {rc}")
    count_launch("msda_bwd", n, lq, spatial_shapes, d)
    return grad_value.to(value.dtype), grad_loc, grad_attn


class MSDAFunction(torch.autograd.Function):
    """The gather kernel's forward launch with the backward kernel as its
    gradient. `wrapper` names the count the forward launch adds to;
    `out_f32` as in `msda_fwd_cuda`."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes, wrapper, out_f32):
        out = msda_fwd_cuda(value, spatial_shapes, sampling_locations,
                            attention_weights, wrapper, out_f32)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        grads = msda_bwd_cuda(grad_out, value, ctx.spatial_shapes, loc, attn)
        return (*grads, None, None, None)


def msda_cuda(value: torch.Tensor,
              spatial_shapes: Sequence[Tuple[int, int]],
              sampling_locations: torch.Tensor,
              attention_weights: torch.Tensor, wrapper: str,
              out_f32: bool = False) -> torch.Tensor:
    """Differentiable launch of the gather kernel -> (N, Lq, M, D) in the
    value dtype, or float32 with `out_f32`."""
    return MSDAFunction.apply(value.contiguous(),
                              sampling_locations.contiguous(),
                              attention_weights.contiguous(),
                              tuple(tuple(hw) for hw in spatial_shapes),
                              wrapper, out_f32)


def v2_levels(n: int, lq: int, m: int,
              spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """The levels of a call that route "v2" sends to the block-skipping
    kernel, as the JAX routing picks them: over the dense budget, at least
    PALLAS_V2_MIN_QUERIES queries, at most PALLAS_V2_MAX_CELLS cells."""
    return [i for i, (h, w) in enumerate(spatial_shapes)
            if n * lq * m * h * w > DENSE_CELL_BUDGET
            and lq >= PALLAS_V2_MIN_QUERIES
            and h * w <= PALLAS_V2_MAX_CELLS]


def dec_skip_levels(n: int, lq: int, m: int,
                    spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """The levels of a call that `MSDA_DEC_SKIP` sends to the range-walking
    kernel, as the JAX routing picks them: fewer than PALLAS_V2_MIN_QUERIES
    queries, over the dense budget, too many cells for the JAX v1 kernel
    (PALLAS_DENSE_MAX_CELLS), at most PALLAS_V2_MAX_CELLS."""
    if not MSDA_DEC_SKIP or lq >= PALLAS_V2_MIN_QUERIES:
        return []
    return [i for i, (h, w) in enumerate(spatial_shapes)
            if n * lq * m * h * w > DENSE_CELL_BUDGET
            and PALLAS_DENSE_MAX_CELLS < h * w <= PALLAS_V2_MAX_CELLS]


def _level_routes(impl: str, n: int, lq: int, m: int, spatial_shapes,
                  loc) -> Dict[int, Callable]:
    """Which levels of a call leave the default route, each with its
    per-level function (value_l, loc_l, attn_l, h, w) -> (N, Lq, M, D)
    float32. Mirrors the JAX routing: the v2 levels under routes "v2" and
    "v4" (queries >= PALLAS_V2_MIN_QUERIES), the dec-skip levels under
    `MSDA_DEC_SKIP` (fewer queries), never both in one call. The sort of a
    call is taken once: from level 0 on route "v4", from the first dec-skip
    level under `MSDA_DEC_SKIP`."""
    from . import msda_dense
    skip = v2_levels(n, lq, m, spatial_shapes) if impl != "v5" else []
    dec = dec_skip_levels(n, lq, m, spatial_shapes)
    if skip and impl == "v2":
        return {i: msda_dense.dense_level_pallas_v2 for i in skip}
    if skip and not PALLAS_V4_SORT:
        return {i: msda_dense.dense_level_pallas_v4 for i in skip}
    if not (skip or dec):
        return {}
    first = 0 if skip else dec[0]
    perm = msda_dense.spatial_sort_perm(loc[:, :, :, first],
                                        *spatial_shapes[first])

    def sorted_level(value_l, loc_l, attn_l, h, w):
        return msda_dense.dense_level_pallas_v4p(value_l, loc_l, attn_l, perm,
                                                 h, w, PALLAS_V4_CW)

    return {i: sorted_level for i in skip or dec}


def _ms_deform_attn_levels(value, spatial_shapes, loc, attn,
                           routes: Dict[int, Callable]):
    """A call whose levels `routes` go each through their own per-level
    function, one launch each: (N, Lq, M, D) float32 sum of those levels and
    of the remaining levels through one launch of the gather kernel, which
    hands over its float32 sums unrounded, so that the call rounds once
    (CPU tensors: the plain versions)."""
    starts = [0]
    for h, w in spatial_shapes:
        starts.append(starts[-1] + h * w)
    out = None
    for i, fn in routes.items():
        h, w = spatial_shapes[i]
        part = fn(value[:, starts[i]:starts[i + 1]], loc[:, :, :, i],
                  attn[:, :, :, i], h, w)
        out = part if out is None else out + part
    rest = [i for i in range(len(spatial_shapes)) if i not in routes]
    if rest:
        shapes = tuple(spatial_shapes[i] for i in rest)
        a, b = rest[0], rest[-1] + 1
        if rest == list(range(a, b)):      # a run of levels: slices
            v = value[:, starts[a]:starts[b]]
            lo, at = loc[:, :, :, a:b], attn[:, :, :, a:b]
        else:
            v = torch.cat([value[:, starts[i]:starts[i + 1]] for i in rest],
                          1)
            lo, at = loc[:, :, :, rest], attn[:, :, :, rest]
        if value.device.type == "cpu":
            part = ms_deform_attn_plain(v, shapes, lo, at)
        else:
            part = msda_cuda(v, shapes, lo, at, "ms_deform_attn",
                             out_f32=True)
        out = part if out is None else out + part
    return out


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA over all levels (module docstring) -> (N, Lq, M*D) in the value
    dtype."""
    n, s, m, d = value.shape
    lq = sampling_locations.shape[1]
    impl = PALLAS_SKIP_IMPL
    if impl not in ("v5", "v2", "v4"):
        raise ValueError(f"PALLAS_SKIP_IMPL={impl!r}: want v5, v2 or v4")
    # a call none of whose levels is re-routed takes the default route
    routes = _level_routes(impl, n, lq, m, spatial_shapes,
                           sampling_locations)
    if routes:
        out = _ms_deform_attn_levels(value, spatial_shapes,
                                     sampling_locations, attention_weights,
                                     routes).to(value.dtype)
    elif value.device.type == "cpu":
        out = ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                   attention_weights).to(value.dtype)
    elif lq == s:
        from .msda_patch import msda_patch
        out = msda_patch(value, spatial_shapes, sampling_locations,
                         attention_weights)
    else:
        out = msda_cuda(value, spatial_shapes, sampling_locations,
                        attention_weights, "ms_deform_attn")
    return out.reshape(n, lq, m * d)
