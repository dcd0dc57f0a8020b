"""MSDA as a weighted gather of precomputed rows.

Counterpart of `ms_deform_attn_pallas` in
`trackformer_tpu/ops/msda_pallas.py`, whose kernel `_msda_kernel` computes,
per (item, head), `out[q] = sum_k w[q, k] * value[idx[q, k]]` over the
K = levels * points * 4 bilinear corners of a query. The corner indices and
the folded weights (bilinear weight * attention weight * in-bounds mask)
are built outside the kernel, in plain tensor code, as the JAX wrapper
builds them (`corner_indices_weights`); the table is float32 and
head-major.

On a CUDA tensor the sum is one launch of `csrc/msda_gather_rows_fwd.cu`;
on a CPU tensor it is the plain version `gather_rows_plain` (a
`torch.gather`, a product and a sum). The contract is `ms_deform_attn`'s
(`ops/msda.py`). No route calls this op, as in the JAX package. Forward
only, as there: an input that requires a gradient raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .cuda_build import MSDA_COMMON, CudaLib
from .msda import count_launch

# warps per block of the kernel: one warp per (item * head, query)
GATHER_WARPS = 8


def corner_indices_weights(spatial_shapes: Sequence[Tuple[int, int]],
                           sampling_locations: torch.Tensor,
                           attention_weights: torch.Tensor):
    """Row indices and folded weights of every (level, point, corner)
    sample: sampling_locations (N, Lq, M, L, P, 2), attention_weights
    (N, Lq, M, L, P) -> idx (N, Lq, M, L, P, 4) int64 into one (item, head)'s
    table of S rows (level offset + y * W + x, clipped into the level) and
    weights of the same shape, float32 (0 for a corner out of range)."""
    idx_levels, w_levels = [], []
    offset = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl].float()
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        dx, dy = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()
        attn = attention_weights[:, :, :, lvl].float()
        idx_c, w_c = [], []
        for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            ix, iy = x0i + cx, y0i + cy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            idx_c.append(offset + iy.clamp(0, h - 1) * w
                         + ix.clamp(0, w - 1))
            wx = dx if cx else 1.0 - dx
            wy = dy if cy else 1.0 - dy
            w_c.append(wx * wy * valid * attn)
        idx_levels.append(torch.stack(idx_c, -1))
        w_levels.append(torch.stack(w_c, -1))
        offset += h * w
    return torch.stack(idx_levels, 3), torch.stack(w_levels, 3)


def gather_rows_plain(idx: torch.Tensor, weights: torch.Tensor,
                      value_nm: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: idx (B, Lq, K) integer, weights
    (B, Lq, K) float32, value_nm (B, S, D) float32 -> (B, Lq, D) float32."""
    b, lq, k = idx.shape
    d = value_nm.shape[2]
    rows = torch.gather(value_nm, 1, idx.reshape(b, lq * k, 1).long()
                        .expand(-1, -1, d))
    return (rows.reshape(b, lq, k, d) * weights[..., None]).sum(2)


LIB = CudaLib("msda_gather_rows_fwd.cu", {"msda_gather_rows_fwd": (
    ctypes.c_int,
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])},
    headers=[MSDA_COMMON])


def gather_rows_cuda(idx: torch.Tensor, weights: torch.Tensor,
                     value_nm: torch.Tensor, heads: int,
                     spatial_shapes: Sequence[Tuple[int, int]]
                     ) -> torch.Tensor:
    """One launch of the kernel: idx (B, Lq, K) int32, weights (B, Lq, K)
    float32, value_nm (B, S, D) float32 -> (B, Lq, D) float32, B = items *
    `heads`. Indices must lie in [0, S), the S cells of `spatial_shapes`.
    Counts the launch as "ms_deform_attn_pallas"."""
    if not (idx.is_cuda and weights.is_cuda and value_nm.is_cuda):
        raise ValueError("msda_gather_rows_fwd: all inputs must be CUDA "
                         "tensors")
    if not (idx.device == weights.device == value_nm.device):
        raise ValueError("msda_gather_rows_fwd: inputs on different devices")
    if idx.dtype != torch.int32 or weights.dtype != torch.float32 \
            or value_nm.dtype != torch.float32:
        raise TypeError("msda_gather_rows_fwd: want int32 indices, float32 "
                        "weights and a float32 table")
    b, lq, k = idx.shape
    if tuple(weights.shape) != (b, lq, k) or value_nm.dim() != 3 \
            or value_nm.shape[0] != b:
        raise ValueError(f"msda_gather_rows_fwd: idx {tuple(idx.shape)}, "
                         f"weights {tuple(weights.shape)}, table "
                         f"{tuple(value_nm.shape)}")
    if not (idx.is_contiguous() and weights.is_contiguous()
            and value_nm.is_contiguous()):
        raise ValueError("msda_gather_rows_fwd: inputs must be contiguous")
    s, d = value_nm.shape[1:]
    if b % heads or s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"msda_gather_rows_fwd: {b} tables of {s} rows for "
                         f"{heads} heads and the levels "
                         f"{tuple(spatial_shapes)}")
    lib = LIB.load()
    out = torch.empty(b, lq, d, dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_gather_rows_fwd(idx.data_ptr(), weights.data_ptr(),
                                      value_nm.data_ptr(), out.data_ptr(),
                                      b, s, lq, k, d, GATHER_WARPS, stream)
    if rc != 0:
        raise RuntimeError(f"msda_gather_rows_fwd launch failed: cudaError "
                           f"{rc}")
    count_launch("ms_deform_attn_pallas", b // heads, lq, spatial_shapes)
    return out


def gather_operands(value: torch.Tensor,
                    spatial_shapes: Sequence[Tuple[int, int]],
                    sampling_locations: torch.Tensor,
                    attention_weights: torch.Tensor):
    """The kernel's operands as the wrapper builds them outside it: idx
    (N*M, Lq, K) int32, weights (N*M, Lq, K) float32 and the head-major
    float32 table (N*M, S, D)."""
    n, s, m, d = value.shape
    lq = sampling_locations.shape[1]
    idx, weights = corner_indices_weights(spatial_shapes, sampling_locations,
                                          attention_weights)
    idx = idx.permute(0, 2, 1, 3, 4, 5).reshape(n * m, lq, -1).to(torch.int32)
    weights = weights.permute(0, 2, 1, 3, 4, 5).reshape(n * m, lq, -1)
    value_nm = value.permute(0, 2, 1, 3).reshape(n * m, s, d).float()
    return idx.contiguous(), weights.contiguous(), value_nm.contiguous()


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
    idx, weights, value_nm = gather_operands(
        value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type == "cpu":
        out = gather_rows_plain(idx, weights, value_nm)
    else:
        out = gather_rows_cuda(idx, weights, value_nm, m, spatial_shapes)
    return out.reshape(n, m, lq, d).permute(0, 2, 1, 3).reshape(
        n, lq, m * d).to(value.dtype)
