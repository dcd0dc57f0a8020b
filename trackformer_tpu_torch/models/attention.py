"""Multi-head attention with a key-padding mask, batch-first.

Counterpart of `trackformer_tpu/models/attention.py`; the decoder's
self-attention uses it. Parameters are laid out as torch's
`nn.MultiheadAttention` (`in_proj_weight` packs q/k/v, then `out_proj`), so
original checkpoints load as they are. Logits and softmax run in float32,
as the JAX package's `preferred_element_type=float32` contraction does, and
every projection rounds as flax's `Dense` does (`dense`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.linear import dense


class MultiHeadAttention(nn.Module):

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """query (B, Q, C), key/value (B, K, C); key_padding_mask (B, K)
        bool, True = exclude the key."""
        b, lq, c = query.shape
        lk = key.shape[1]
        h, dh = self.num_heads, c // self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = dense(query, wq, bq).view(b, lq, h, dh).transpose(1, 2)
        k = dense(key, wk, bk).view(b, lk, h, dh).transpose(1, 2)
        v = dense(value, wv, bv).view(b, lk, h, dh).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / math.sqrt(dh)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(torch.float32).min)
        attn = logits.softmax(-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, lq, c)
        return dense(out, self.out_proj.weight, self.out_proj.bias)
