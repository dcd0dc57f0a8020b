"""All-levels MSDA for the encoder self-pattern (Lq == S).

Counterpart of `msda_patch` in `trackformer_tpu/ops/msda_patch.py`, whose
fused patch-walk kernel `_kernel_v5` walks value chunks per query tile on
the TPU. On the card the same function is one launch of the gather kernel
in `csrc/msda_fwd.cu` over all levels (see `ops/msda.py`); on a CPU tensor
it is the plain version.

It keeps the TPU contract: every level at once, and queries are the level
tokens themselves (Lq == S). The output is (N, Lq, M, D) in the value dtype,
where the TPU kernel returns float32; its one caller casts to the value
dtype either way. Differentiable (`ops/msda.py:MSDAFunction`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .msda import ms_deform_attn_plain, msda_cuda


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
