"""One level's MSDA contribution.

Counterpart of `dense_level_pallas` in `trackformer_tpu/ops/msda_dense.py`,
whose v1 kernel `_kernel` builds the level's bilinear hat weights as a
dense (query, cell) tile on the TPU and multiplies it with the values. On
the card the same function is one launch of the gather kernel in
`csrc/msda_fwd.cu` with this single level (see `ops/msda.py`); on a CPU
tensor it is the plain version.

The main path does not call it on the card: there `ms_deform_attn` takes
all eight decoder levels, this one included, in one launch. It is kept at
its TPU contract so that the kernel can be held against the v1 kernel at
the decoder's single-level shape.
"""
from __future__ import annotations

import torch

from .msda import level_plain, msda_fwd_cuda


def dense_level_pallas(value_l: torch.Tensor, loc_l: torch.Tensor,
                       attn_l: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """value_l (N, H*W, M, D); loc_l (N, Lq, M, P, 2); attn_l (N, Lq, M, P)
    -> (N, Lq, M, D) in the value dtype (the TPU kernel returns float32)."""
    if value_l.shape[1] != h * w:
        raise ValueError(f"{value_l.shape[1]} cells for a {h}x{w} level")
    if value_l.device.type == "cpu":
        return level_plain(value_l, loc_l, attn_l, h, w).to(value_l.dtype)
    return msda_fwd_cuda(value_l.contiguous(), ((h, w),),
                         loc_l.unsqueeze(3).contiguous(),
                         attn_l.unsqueeze(3).contiguous(),
                         "dense_level_pallas")
