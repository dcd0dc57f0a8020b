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

On a CUDA tensor the op is ONE launch of the kernel in `csrc/msda_fwd.cu`
over all levels of the call: the encoder's self-pattern (Lq == S) goes
through `msda_patch`, every other call through the launch here. That covers
what the TPU package splits over its v5 patch kernel, its v1 dense kernel
and its XLA dense and gather paths, a routing that exists there only for
the TPU's missing gather. On a CPU tensor the op runs the plain version
`ms_deform_attn_plain`. Nothing falls back from the kernel to the plain
version.

The kernel is built from `csrc/msda_fwd.cu` at first use (`cuda_build.py`).
This slice is forward only: a CUDA call with inputs that require grad
raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .cuda_build import CudaLib
# queries per block: enough work per block to amortize its start, small
# enough that the encoder call still spreads over every SM several times
Q_PER_BLOCK = 4


# Launches of the kernel by wrapper: the port's only global state. They
# show that a run went through the kernel; each wrapper adds one where it
# launches and nowhere else.
LAUNCHES: Dict[str, int] = {"ms_deform_attn": 0, "msda_patch": 0,
                            "dense_level_pallas": 0}


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p])})


def _check_inputs(value, spatial_shapes, loc, attn):
    if not (value.is_cuda and loc.is_cuda and attn.is_cuda):
        raise ValueError("msda_fwd: all inputs must be CUDA tensors")
    if not (value.device == loc.device == attn.device):
        raise ValueError("msda_fwd: inputs on different devices")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"msda_fwd: value dtype {value.dtype}")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("msda_fwd: locations and weights must be float32")
    if torch.is_grad_enabled() and (value.requires_grad or loc.requires_grad
                                    or attn.requires_grad):
        raise RuntimeError("msda_fwd is forward-only: call it under "
                           "torch.no_grad() (the backward kernel is not "
                           "ported yet)")
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
                  wrapper: str) -> torch.Tensor:
    """One launch of the CUDA kernel over the given levels -> (N, Lq, M, D)
    in the value dtype. Counts the launch for `wrapper`."""
    _check_inputs(value, spatial_shapes, sampling_locations,
                  attention_weights)
    lib = LIB.load()
    n, s, m, d = value.shape
    _, lq, _, l, p, _ = sampling_locations.shape
    out = torch.empty(n, lq, m, d, dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * l))(*[int(v) for hw in spatial_shapes
                                        for v in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_fwd(value.data_ptr(), sampling_locations.data_ptr(),
                          attention_weights.data_ptr(), out.data_ptr(),
                          n, s, lq, m, l, p, d, shapes,
                          int(value.dtype == torch.bfloat16), Q_PER_BLOCK,
                          stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd launch failed: cudaError {rc}")
    LAUNCHES[wrapper] += 1
    return out


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA over all levels (module docstring) -> (N, Lq, M*D) in the value
    dtype."""
    n, s, m, d = value.shape
    lq = sampling_locations.shape[1]
    if value.device.type == "cpu":
        out = ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                   attention_weights).to(value.dtype)
    elif lq == s:
        from .msda_patch import msda_patch
        out = msda_patch(value, spatial_shapes, sampling_locations,
                         attention_weights)
    else:
        out = msda_fwd_cuda(value.contiguous(), spatial_shapes,
                            sampling_locations.contiguous(),
                            attention_weights.contiguous(), "ms_deform_attn")
    return out.reshape(n, lq, m * d)
