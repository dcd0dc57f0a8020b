"""One level's MSDA contribution: the plain-tiling and the block-skipping
function of the JAX package.

Counterpart of `dense_level_pallas` and `dense_level_pallas_v2` in
`trackformer_tpu/ops/msda_dense.py`.

`dense_level_pallas`: the TPU's v1 kernel `_kernel` builds the level's
bilinear hat weights as a dense (query, cell) tile and multiplies it with
the values. On the card the same function is one launch of the gather
kernel in `csrc/msda_fwd.cu` with this single level (see `ops/msda.py`).
The main path does not call it on the card: there `ms_deform_attn` takes
all eight decoder levels, this one included, in one launch. It is kept at
its TPU contract so that the kernel can be held against the v1 kernel at
the decoder's single-level shape.

`dense_level_pallas_v2`: the TPU's `_kernel_v2` skips every (query tile,
row tile) pair whose row ranges miss. On the card it is one launch of
`csrc/msda_dense_v2_fwd.cu`: a block per (head, tile of `V2_TQ` consecutive
queries, item) stages only the tile's band of value rows (`v2_row_band`)
into shared memory and samples from there. Route "v2" of `ms_deform_attn`
reaches it for every level of the flagship encoder call.

Both are differentiable: the backward of either is the backward kernel of
`ops/msda.py` launched for the single level, as the JAX package shares one
`_bwd`. On a CPU tensor both are the plain version `level_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLib
from .msda import count_launch, level_plain, msda_bwd_cuda, msda_cuda

# queries per tile of the block-skipping kernel (the JAX package's V2_TQ)
V2_TQ = 256
# shared memory for staged value rows per block, and threads per block
V2_CHUNK_BYTES = 48 * 1024
V2_THREADS = 256


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


V2_LIB = CudaLib("msda_dense_v2_fwd.cu", {"msda_dense_v2_fwd": (
    ctypes.c_int,
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p])})


def dense_level_v2_fwd_cuda(value_l: torch.Tensor, loc_l: torch.Tensor,
                            attn_l: torch.Tensor, h: int, w: int,
                            tq: int = V2_TQ, return_band: bool = False):
    """One launch of the block-skipping kernel -> (N, Lq, M, D) float32;
    with `return_band` also the kernel's own (N, ceil(Lq / tq), 2) int32
    row bands clipped to the level (lo > hi: empty). Counts the launch as
    "dense_level_pallas_v2"."""
    if not (value_l.is_cuda and loc_l.is_cuda and attn_l.is_cuda):
        raise ValueError("msda_dense_v2_fwd: all inputs must be CUDA tensors")
    if not (value_l.device == loc_l.device == attn_l.device):
        raise ValueError("msda_dense_v2_fwd: inputs on different devices")
    if value_l.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"msda_dense_v2_fwd: value dtype {value_l.dtype}")
    if loc_l.dtype != torch.float32 or attn_l.dtype != torch.float32:
        raise TypeError("msda_dense_v2_fwd: locations and weights must be "
                        "float32")
    n, cells, m, d = value_l.shape
    if cells != h * w:
        raise ValueError(f"{cells} cells for a {h}x{w} level")
    lq, p = loc_l.shape[1], loc_l.shape[3]
    if tuple(loc_l.shape) != (n, lq, m, p, 2) \
            or tuple(attn_l.shape) != (n, lq, m, p):
        raise ValueError(f"msda_dense_v2_fwd: loc {tuple(loc_l.shape)}, "
                         f"attn {tuple(attn_l.shape)}")
    if not (value_l.is_contiguous() and loc_l.is_contiguous()
            and attn_l.is_contiguous()):
        raise ValueError("msda_dense_v2_fwd: inputs must be contiguous")
    lib = V2_LIB.load()
    out = torch.empty(n, lq, m, d, dtype=torch.float32,
                      device=value_l.device)
    band = (torch.empty(n, -(-lq // tq), 2, dtype=torch.int32,
                        device=value_l.device) if return_band else None)
    with torch.cuda.device(value_l.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_dense_v2_fwd(
            value_l.data_ptr(), loc_l.data_ptr(), attn_l.data_ptr(),
            out.data_ptr(), None if band is None else band.data_ptr(),
            n, h, w, lq, m, p, d, int(value_l.dtype == torch.bfloat16), tq,
            V2_CHUNK_BYTES, V2_THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"msda_dense_v2_fwd launch failed: cudaError {rc}")
    count_launch("dense_level_pallas_v2", n, lq, ((h, w),))
    return (out, band) if return_band else out


class DenseLevelV2Function(torch.autograd.Function):
    """The block-skipping forward with the shared MSDA backward kernel,
    launched for the single level, as its gradient."""

    @staticmethod
    def forward(ctx, value_l, loc_l, attn_l, h, w):
        out = dense_level_v2_fwd_cuda(value_l, loc_l, attn_l, h, w)
        ctx.save_for_backward(value_l, loc_l, attn_l)
        ctx.hw = (h, w)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value_l, loc_l, attn_l = ctx.saved_tensors
        gv, gl, ga = msda_bwd_cuda(grad_out, value_l, (ctx.hw,),
                                   loc_l.unsqueeze(3), attn_l.unsqueeze(3))
        return gv, gl.squeeze(3), ga.squeeze(3), None, None


def dense_level_pallas_v2(value_l: torch.Tensor, loc_l: torch.Tensor,
                          attn_l: torch.Tensor, h: int, w: int
                          ) -> torch.Tensor:
    """Block-skipping variant of `dense_level_pallas`, same semantics:
    value_l (N, H*W, M, D); loc_l (N, Lq, M, P, 2); attn_l (N, Lq, M, P)
    -> (N, Lq, M, D) float32, as the TPU kernel returns it."""
    if value_l.shape[1] != h * w:
        raise ValueError(f"{value_l.shape[1]} cells for a {h}x{w} level")
    if value_l.device.type == "cpu":
        return level_plain(value_l, loc_l, attn_l, h, w)
    return DenseLevelV2Function.apply(value_l.contiguous(),
                                      loc_l.contiguous(),
                                      attn_l.contiguous(), h, w)
