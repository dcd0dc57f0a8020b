"""Dense layers rounded as the JAX package rounds them."""
from __future__ import annotations

import torch
from torch.nn import functional as F


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """x W^T + b as flax's `Dense` computes it in a low-precision dtype: the
    product (summed in float32) is rounded to the compute dtype first, and
    the bias is added in that dtype after. In float32 this is `F.linear`."""
    return F.linear(x, weight) + bias
