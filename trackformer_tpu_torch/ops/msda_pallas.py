"""MSDA as a weighted gather of precomputed rows.

Counterpart of `ms_deform_attn_pallas` in
`trackformer_tpu/ops/msda_pallas.py`, whose kernel `_msda_kernel` computes,
per (item, head), `out[q] = sum_k w[q, k] * value[idx[q, k]]` over the
K = levels * points * 4 bilinear corners of a query. The corner indices and
the folded weights (bilinear weight * attention weight * in-bounds mask)
are the JAX wrapper's (`_corner_indices_weights`), step by step in the
dtype that JAX's promotion gives them (`corner_indices_weights`).

On a CUDA tensor the op is two launches of `csrc/msda_gather_rows_fwd.cu`:
the corner build (`corner_operands_cuda`: idx (N*M, Lq, K) int32 and the
folded weights float32, in the layout the gather reads) and the gather
(`gather_rows_cuda`), which reads the (N, S, M, D) value where it lies, in
its own dtype, and writes (N, Lq, M, D) in the value dtype, as the host's
plan `gather_plan` splits it. On a CPU tensor the op runs the plain
versions `corner_operands_plain` and `gather_rows_plain`. The contract is
`ms_deform_attn`'s (`ops/msda.py`), with locations and weights in float32
or bfloat16 on the card. No route calls this op, as in the JAX package.
Forward only, as there: an input that requires a gradient raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from .cuda_build import MSDA_COMMON, CudaLib
from .msda import count_launch

# the gather's warps per block (fewer when the corner buffers would not fit
# `GATHER_SMEM` bytes of shared memory), and the blocks that make a call
# fill the card
GATHER_WARPS = 4
GATHER_SMEM = 48 * 1024
GATHER_SMS = 132
# levels the corner build's C entry point takes
CORNER_MAX_LEVELS = 64
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def corner_indices_weights(spatial_shapes: Sequence[Tuple[int, int]],
                           sampling_locations: torch.Tensor,
                           attention_weights: torch.Tensor):
    """Row indices and folded weights of every (level, point, corner)
    sample, as the JAX wrapper builds them: sampling_locations
    (N, Lq, M, L, P, 2), attention_weights (N, Lq, M, L, P) -> idx
    (N, Lq, M, L, P, 4) int64 into one (item, head)'s table of S rows
    (level offset + y * W + x, clipped into the level) and weights of the
    same shape, widened to float32 at the end (0 for a corner out of
    range).

    Every step runs in the dtype that JAX's promotion gives it: `loc * W
    - 0.5`, `floor`, `x - x0`, `1 - dx` and `wx * wy * valid` in the
    locations' dtype (the level size rounded to it first, as JAX converts
    a Python int), the product with the attention weights in the
    promotion of the two dtypes."""
    dt = sampling_locations.dtype
    idx_levels, w_levels = [], []
    offset = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl]
        # JAX converts the Python int to the array's dtype: 337 is 336 in
        # bfloat16, where torch would multiply by 337 exactly
        w_t = float(torch.tensor(float(w), dtype=dt))
        h_t = float(torch.tensor(float(h), dtype=dt))
        x = loc[..., 0] * w_t - 0.5
        y = loc[..., 1] * h_t - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        dx, dy = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()
        attn = attention_weights[:, :, :, lvl]
        idx_c, w_c = [], []
        for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            ix, iy = x0i + cx, y0i + cy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            idx_c.append(offset + iy.clamp(0, h - 1) * w
                         + ix.clamp(0, w - 1))
            wx = dx if cx else 1.0 - dx
            wy = dy if cy else 1.0 - dy
            w_c.append((wx * wy * valid * attn).float())
        idx_levels.append(torch.stack(idx_c, -1))
        w_levels.append(torch.stack(w_c, -1))
        offset += h * w
    return torch.stack(idx_levels, 3), torch.stack(w_levels, 3)


def corner_operands_plain(spatial_shapes: Sequence[Tuple[int, int]],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor):
    """Plain version of the corner build: the operands in the gather's
    layout, idx (N*M, Lq, K) int32 and weights (N*M, Lq, K) float32, K =
    L * P * 4 in (level, point, corner) order, as the JAX wrapper lays them
    out for its kernel."""
    n, lq, m = sampling_locations.shape[:3]
    idx, weights = corner_indices_weights(spatial_shapes, sampling_locations,
                                          attention_weights)
    idx = idx.permute(0, 2, 1, 3, 4, 5).reshape(n * m, lq, -1)
    weights = weights.permute(0, 2, 1, 3, 4, 5).reshape(n * m, lq, -1)
    return idx.to(torch.int32).contiguous(), weights.contiguous()


def gather_rows_plain(idx: torch.Tensor, weights: torch.Tensor,
                      value: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather: idx (N*M, Lq, K) integer rows of one
    (item, head)'s S cells, weights (N*M, Lq, K) float32, value (N, S, M, D)
    in any dtype -> (N, Lq, M, D) float32, the sums in float32."""
    n, s, m, d = value.shape
    b, lq, k = idx.shape
    table = value.float().permute(0, 2, 1, 3).reshape(b, s, d)
    rows = torch.gather(table, 1, idx.reshape(b, lq * k, 1).long()
                        .expand(-1, -1, d))
    out = (rows.reshape(b, lq, k, d) * weights[..., None]).sum(2)
    return out.reshape(n, m, lq, d).permute(0, 2, 1, 3)


class GatherPlan(NamedTuple):
    """How the gather kernel serves one call. A head's row of D elements
    is `words` words of `word` bytes. A warp's lanes are `groups` groups of
    min(words, 32) lanes; it takes `qstep` consecutive queries, each served
    by groups / qstep groups, lane (g, j) loading word j of the rows of its
    query's corners [c * chunk, (c + 1) * chunk), c = g mod (groups /
    qstep) (`chunk` a multiple of 4; in `passes` passes of 32 words when a
    row has more than 32). `warps` warps a block, warp w of tile x on
    queries (x * warps + w) * qstep + [0, qstep), their indices and weights
    in `smem_bytes`; the launch grid is (query tiles, items * heads)."""
    word: int
    words: int
    groups: int
    qstep: int
    chunk: int
    passes: int
    warps: int
    smem_bytes: int
    grid: Tuple[int, int]


def gather_plan(n: int, lq: int, m: int, k: int, d: int, es: int,
                value_ptr: int, sms: int = GATHER_SMS) -> GatherPlan:
    """The plan of the gather kernel for a call with head rows of d
    elements of es bytes at `value_ptr`: the widest word of 16, 8, 4 or 2
    bytes (not below an element) that divides a head's row and the
    pointer's alignment; a query for each lane group (its corners summed
    in order by one group, no reduction) when the call still fills the
    card with 8 * `sms` blocks, else one query a warp over all groups."""
    word = next((w for w in (16, 8, 4, 2)
                 if w >= es and (d * es) % w == 0 and value_ptr % w == 0),
                None)
    if word is None:
        raise ValueError(f"msda_gather_rows_fwd: a value pointer at "
                         f"{value_ptr % 16} mod 16 is not aligned to its "
                         f"{es}-byte elements")
    words = d * es // word
    lanes = min(words, 32)
    groups = 32 // lanes
    per_query = 8 * k + 16                # K ints + K floats, padded
    if per_query > GATHER_SMEM:
        raise ValueError(f"msda_gather_rows_fwd: {k} corners a query do not "
                         f"fit {GATHER_SMEM} bytes of shared memory")

    def warps(qstep):
        return min(GATHER_WARPS, GATHER_SMEM // (qstep * per_query))

    def tiles(qstep):
        return -(-lq // (warps(qstep) * qstep))

    qstep = next((q for q in range(groups, 1, -1)
                  if groups % q == 0 and q * per_query <= GATHER_SMEM
                  and tiles(q) * n * m >= 8 * sms), 1)
    per_group = -(-k // (groups // qstep))
    return GatherPlan(word, words, groups, qstep, -(-per_group // 4) * 4,
                      -(-words // lanes), warps(qstep),
                      warps(qstep) * qstep * per_query,
                      (max(1, tiles(qstep)), n * m))


LIB = CudaLib("msda_gather_rows_fwd.cu", {
    "msda_gather_rows_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p]),
    "msda_corners_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 2
        + [ctypes.c_void_p])},
    headers=[MSDA_COMMON])


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: all inputs must be CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def corner_operands_cuda(spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor):
    """One launch of the corner build: equal to `corner_operands_plain`
    bit for bit, for float32 or bfloat16 locations and weights. Counts the
    launch as "ms_deform_attn_pallas_corners"."""
    loc, attn = sampling_locations, attention_weights
    _check_cuda("msda_corners_fwd", loc, attn)
    if loc.dtype not in KERNEL_DTYPES or attn.dtype not in KERNEL_DTYPES:
        raise TypeError(f"msda_corners_fwd: locations {loc.dtype} and "
                        f"weights {attn.dtype}: want float32 or bfloat16")
    n, lq, m, l, p, two = loc.shape
    if two != 2 or tuple(attn.shape) != (n, lq, m, l, p) \
            or l != len(spatial_shapes):
        raise ValueError(f"msda_corners_fwd: locations {tuple(loc.shape)}, "
                         f"weights {tuple(attn.shape)} for the levels "
                         f"{tuple(spatial_shapes)}")
    if l > CORNER_MAX_LEVELS:
        raise ValueError(f"msda_corners_fwd: {l} levels, at most "
                         f"{CORNER_MAX_LEVELS}")
    k = l * p * 4
    idx = torch.empty(n * m, lq, k, dtype=torch.int32, device=loc.device)
    weights = torch.empty(n * m, lq, k, dtype=torch.float32,
                          device=loc.device)
    hw = (ctypes.c_int * (2 * l))(*[int(v) for pair in spatial_shapes
                                   for v in pair])
    lib = LIB.load()
    with torch.cuda.device(loc.device):
        rc = lib.msda_corners_fwd(
            loc.data_ptr(), attn.data_ptr(), idx.data_ptr(),
            weights.data_ptr(), n, lq, m, l, p, hw,
            int(loc.dtype == torch.bfloat16),
            int(attn.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"msda_corners_fwd launch failed: cudaError {rc}")
    count_launch("ms_deform_attn_pallas_corners", n, lq, spatial_shapes)
    return idx, weights


def gather_rows_cuda(idx: torch.Tensor, weights: torch.Tensor,
                     value: torch.Tensor,
                     spatial_shapes: Sequence[Tuple[int, int]]
                     ) -> torch.Tensor:
    """One launch of the gather: idx (N*M, Lq, K) int32 rows of one (item,
    head)'s S cells, weights (N*M, Lq, K) float32, value (N, S, M, D)
    float32 or bfloat16 read in place -> (N, Lq, M, D) in the value dtype,
    the sums in float32, served as `gather_plan` says.
    Indices must lie in [0, S), the S cells of `spatial_shapes`. Counts the
    launch as "ms_deform_attn_pallas"."""
    _check_cuda("msda_gather_rows_fwd", idx, weights, value)
    if idx.dtype != torch.int32 or weights.dtype != torch.float32 \
            or value.dtype not in KERNEL_DTYPES:
        raise TypeError(f"msda_gather_rows_fwd: idx {idx.dtype}, weights "
                        f"{weights.dtype}, value {value.dtype}: want int32, "
                        "float32 and float32 or bfloat16")
    n, s, m, d = value.shape
    b, lq, k = idx.shape
    if tuple(weights.shape) != (b, lq, k) or b != n * m or k % 4 \
            or s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"msda_gather_rows_fwd: idx {tuple(idx.shape)}, "
                         f"weights {tuple(weights.shape)}, value "
                         f"{tuple(value.shape)} for the levels "
                         f"{tuple(spatial_shapes)}")
    plan = gather_plan(n, lq, m, k, d, value.element_size(),
                       value.data_ptr())
    out = torch.empty(n, lq, m, d, dtype=value.dtype, device=value.device)
    lib = LIB.load()
    with torch.cuda.device(value.device):
        rc = lib.msda_gather_rows_fwd(
            idx.data_ptr(), weights.data_ptr(), value.data_ptr(),
            out.data_ptr(), n, s, m, lq, k, d,
            int(value.dtype == torch.bfloat16), plan.word, plan.qstep,
            plan.chunk, plan.passes, plan.warps, plan.smem_bytes,
            plan.grid[0],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"msda_gather_rows_fwd launch failed: cudaError "
                           f"{rc}")
    count_launch("ms_deform_attn_pallas", n, lq, spatial_shapes)
    return out


def ms_deform_attn_pallas(value: torch.Tensor,
                          spatial_shapes: Sequence[Tuple[int, int]],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor) -> torch.Tensor:
    """Same contract as `ops.msda.ms_deform_attn`: value (N, S, M, D);
    sampling_locations (N, Lq, M, L, P, 2); attention_weights
    (N, Lq, M, L, P) -> (N, Lq, M*D) in the value dtype. Forward only."""
    n, s, m, d = value.shape
    lq, l = sampling_locations.shape[1], sampling_locations.shape[3]
    if l != len(spatial_shapes) or s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"{s} tokens, {l} levels of locations for the "
                         f"levels {tuple(spatial_shapes)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations,
                                      attention_weights)):
        raise RuntimeError("ms_deform_attn_pallas is forward only, as in the "
                           "JAX package: use ms_deform_attn for gradients")
    if value.device.type == "cpu":
        idx, weights = corner_operands_plain(
            spatial_shapes, sampling_locations, attention_weights)
        out = gather_rows_plain(idx, weights, value).to(value.dtype)
    else:
        idx, weights = corner_operands_cuda(
            spatial_shapes, sampling_locations.contiguous(),
            attention_weights.contiguous())
        out = gather_rows_cuda(idx, weights, value.contiguous(),
                               spatial_shapes)
    return out.reshape(n, lq, m * d)
