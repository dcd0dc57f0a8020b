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
a ring of chunk copies in flight. On the card: `v6_walk` in tensor code on
the device, then one launch of `csrc/msda_patch_v6_fwd.cu` -> (N, Lq, M, D)
float32 as the TPU kernel returns it; the backward is the backward kernel
of `ops/msda.py` over all levels. On a CPU tensor it is the plain version.
No route calls it, as in the JAX package. The chunk geometry is the card's
(8 x 32 cells, four slots: a block has 227 KB of shared memory where the
TPU kernel stages 3 MB), not the TPU's 16 x 64.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .cuda_build import MSDA_COMMON, CudaLib
from .msda import (_check_inputs, count_launch, ms_deform_attn_plain,
                   msda_bwd_cuda, msda_cuda)

# kernel v6 on the card: queries per tile, chunk rows and columns in cells,
# chunk copies in flight + 1, threads per block
V6_TQ = 128
V6_PH = 8
V6_PW = 32
V6_NSLOTS = 4
V6_THREADS = 256


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


V6_LIB = CudaLib("msda_patch_v6_fwd.cu", {"msda_patch_v6_fwd": (
    ctypes.c_int,
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7
    + [ctypes.c_void_p])}, headers=[MSDA_COMMON])


def msda_patch_v6_fwd_cuda(value: torch.Tensor,
                           spatial_shapes: Sequence[Tuple[int, int]],
                           sampling_locations: torch.Tensor,
                           attention_weights: torch.Tensor,
                           tq: Optional[int] = None, ph: Optional[int] = None,
                           pw: Optional[int] = None,
                           nslots: Optional[int] = None,
                           walk=None) -> torch.Tensor:
    """`v6_walk` (unless the caller hands its result in as `walk`) and one
    launch of the flat-walk kernel -> (N, S, M, D) float32. Counts the
    launch as "msda_patch_v6"."""
    _check_inputs(value, spatial_shapes, sampling_locations,
                  attention_weights)
    n, s, m, d = value.shape
    _, lq, _, l, p, _ = sampling_locations.shape
    if lq != s:
        raise ValueError(f"msda_patch_v6 needs Lq == S, got Lq={lq}, S={s}")
    tq = V6_TQ if tq is None else tq
    ph = V6_PH if ph is None else ph
    pw = V6_PW if pw is None else pw
    nslots = V6_NSLOTS if nslots is None else nslots
    shapes = tuple(tuple(hw) for hw in spatial_shapes)
    codes, totals = walk if walk is not None else v6_walk(
        shapes, sampling_locations, tq, ph, pw)
    maxc = v6_max_chunks(shapes, ph, pw)
    if tuple(codes.shape) != (n, -(-s // tq), maxc) \
            or codes.dtype != torch.int32 or not codes.is_contiguous():
        raise ValueError(f"msda_patch_v6: codes {tuple(codes.shape)}")
    totals = totals.contiguous()
    perm = _snake_perm_on(shapes, value.device)
    lib = V6_LIB.load()
    out = torch.empty(n, s, m, d, dtype=torch.float32, device=value.device)
    hw = (ctypes.c_int * (2 * l))(*[int(v) for pair in shapes for v in pair])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_patch_v6_fwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), perm.data_ptr(), codes.data_ptr(),
            totals.data_ptr(), out.data_ptr(), n, s, m, l, p, d, hw,
            int(value.dtype == torch.bfloat16), tq, ph, pw, nslots, maxc,
            V6_THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"msda_patch_v6_fwd launch failed: cudaError {rc}")
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
