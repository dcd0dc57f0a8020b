"""Multi-head attention with a key-padding mask, batch-first.

Counterpart of `trackformer_tpu/models/attention.py`; the decoder's
self-attention uses it. Parameters are laid out as torch's
`nn.MultiheadAttention` (`in_proj_weight` packs q/k/v, then `out_proj`), so
original checkpoints load as they are. Logits and softmax run in float32,
as the JAX package's `preferred_element_type=float32` contraction does, and
every projection rounds as flax's `Dense` does (`dense`).

With `keep_weights` set, a call keeps its head-averaged float32 attention
weights (B, Q, K), before dropout, in `weights` (the JAX package sows them
as `attn_weights`): vanilla DETR's attention maps read the last decoder
layer's cross-attention there. The flag is off by default and costs the
default path nothing but its test.

`Dropout` is the port's dropout: inactive in `eval()`, and in training it
draws its mask from an explicit `torch.Generator` on the tensor's device
(`set_dropout_generator`), never from the global one. `remat` runs a
layer under `torch.utils.checkpoint` (the JAX package's `nn.remat`) and
replays those generators in the recompute, which the checkpoint cannot
do itself: it stashes the global CPU and CUDA generators only.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.linear import dense


class Dropout(nn.Module):
    """Zero each element with probability `p` and scale the rest by
    1 / (1 - p), in training mode only."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device,
                          generator=self.generator) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Make every `Dropout` of `model` draw from `generator`."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


def remat(fn: Callable, module: nn.Module, *args):
    """`fn(*args)` with its activations recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant). `module` holds every
    `Dropout` that `fn` runs: their generators' states are saved before
    the forward, set back for the recompute, so that it draws the masks
    the forward drew, and then set to where the forward left them. A step
    with remat is therefore bit-equal to one without, in its loss and in
    every gradient."""
    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, Dropout) and m.generator is not None
                 }.values())
    before = [g.get_state() for g in gens]
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        after = [g.get_state() for g in gens]
        for g, state in zip(gens, before):
            g.set_state(state)
        try:
            return fn(*a)
        finally:
            # the recompute may stop early, once it has what the backward
            # needs: the generators go back either way
            for g, state in zip(gens, after):
                g.set_state(state)

    return checkpoint(run, *args, use_reentrant=False)


class MultiHeadAttention(nn.Module):

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.attn_drop = Dropout(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.keep_weights = False
        self.weights: Optional[torch.Tensor] = None

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
        if self.keep_weights:
            self.weights = attn.float().mean(1)
        attn = self.attn_drop(attn)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, lq, c)
        return dense(out, self.out_proj.weight, self.out_proj.bias)
