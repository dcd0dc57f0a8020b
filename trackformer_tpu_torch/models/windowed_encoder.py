"""TPU-fast encoder: shifted-window dense self-attention over all levels.

Counterpart of `trackformer_tpu/models/windowed_encoder.py` (the encoder of
`cfgs/tpu_fast.yaml`). Every layer shares its weights across the levels of
a frame: the levels are cut into 8x8-token windows (shifted by half a
window on odd layers, Swin-style), all windows of all levels go through ONE
call of the windowed layer (`ops/window_attn.py`), and a cross-level fusion
then mixes each level with its resized neighbours. The output is the
flattened memory in the deformable encoder's token order.

The JAX package's default layout is ported (per-level roll, pad and window
partition; `GATHER_LAYOUT` "0") with its default "perlevel" fusion; its
gather layout and batched fusion are TPU A/B knobs and are not ported. The
JAX code is NHWC; the port's projected features are NCHW, and the encoder
takes them so and converts once at its boundary.

A layer in eval mode (deterministic) goes through `window_layer`: kernel
#8 on the card. The kernel has no backward, here as in JAX, so a layer in
training mode runs the JAX module path instead (`_train_forward`, the
`else:` branch of `trackformer_tpu/models/windowed_encoder.py:295-312`):
attention, dropout, residual and `norm1`, then the FFN with dropout after
the ReLU and after `linear2`, residual and `norm2`, in the windowed layout.
The route follows the module's mode, never a kernel's failure.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.window_attn import window_layer
from ..ops.linear import dense
from .attention import Dropout, MultiHeadAttention

LN_EPS = 1e-6


def pad_hw(x: torch.Tensor, win: int) -> Tuple[torch.Tensor, int, int]:
    """(B, H, W, C) zero-padded at the bottom and right to multiples of
    `win` -> (x, H', W')."""
    _, h, w, _ = x.shape
    ph, pw = (-h) % win, (-w) % win
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x, h + ph, w + pw


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nWin, win * win, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def window_merge(x: torch.Tensor, b: int, h: int, w: int,
                 win: int) -> torch.Tensor:
    """Inverse of `window_partition` -> (B, H, W, C)."""
    c = x.shape[-1]
    x = x.reshape(b, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def window_context(poses: Sequence[torch.Tensor],
                   masks: Sequence[torch.Tensor], win: int, shift: bool,
                   dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed positions (NW, win^2, C) in `dtype` and key padding
    (NW, win^2) bool of all levels for one shift parity. Slots past a
    level's edge are excluded; a window with every slot excluded is
    un-masked, since its softmax would degenerate. Positions and masks do
    not change across layers, so the encoder builds this once per parity."""
    sh = win // 2 if shift else 0
    pw_all, kp_all = [], []
    for p, m in zip(poses, masks):
        _, h0, w0, _ = p.shape
        mf = m[..., None].float()
        if sh:
            p = torch.roll(p, (-sh, -sh), (1, 2))
            mf = torch.roll(mf, (-sh, -sh), (1, 2))
        p, hp, wp = pad_hw(p, win)
        mf = F.pad(mf, (0, 0, 0, wp - w0, 0, hp - h0), value=1.0)
        kp_all.append(window_partition(mf, win)[..., 0] > 0.5)
        pw_all.append(window_partition(p.to(dtype), win))
    pw = torch.cat(pw_all, 0)
    kp = torch.cat(kp_all, 0)
    return pw, kp & ~kp.all(1, keepdim=True)


class WindowedEncoderLayer(nn.Module):
    """One shared-weight layer over all levels: one windowed-layer call on
    the concatenation of every level's windows (module docstring: eval
    mode through kernel #8, training mode through `_train_forward`)."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int,
                 window: int, shift: bool, dropout: float = 0.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.self_attn = MultiHeadAttention(d_model, nheads, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = Dropout(dropout)

    def _train_forward(self, xw: torch.Tensor, pw: torch.Tensor,
                       kp: torch.Tensor) -> torch.Tensor:
        """The layer over every window as modules, with dropout: the
        training path, differentiable end to end."""
        q = xw + pw
        x = self.norm1(xw + self.drop(self.self_attn(q, q, xw, kp)))
        hidden = self.drop(torch.relu(
            dense(x, self.linear1.weight, self.linear1.bias)))
        return self.norm2(x + self.drop(
            dense(hidden, self.linear2.weight, self.linear2.bias)))

    def forward(self, levels: List[torch.Tensor],
                ctx: Tuple[torch.Tensor, torch.Tensor]
                ) -> List[torch.Tensor]:
        """levels: (B, H_l, W_l, C) each; ctx: `window_context` of this
        layer's shift parity."""
        win = self.window
        sh = win // 2 if self.shift else 0
        xw_all, meta = [], []
        for x in levels:
            b, h0, w0, _ = x.shape
            if sh:
                x = torch.roll(x, (-sh, -sh), (1, 2))
            x, hp, wp = pad_hw(x, win)
            xw_all.append(window_partition(x, win))
            meta.append((b, h0, w0, hp, wp, xw_all[-1].shape[0]))
        xw = torch.cat(xw_all, 0)
        if self.training:
            x = self._train_forward(xw, ctx[0], ctx[1])
        else:
            x = window_layer(xw, ctx[0], ctx[1], self)
        out, off = [], 0
        for b, h0, w0, hp, wp, n in meta:
            a = window_merge(x[off:off + n], b, hp, wp, win)[:, :h0, :w0]
            off += n
            if sh:
                a = torch.roll(a, (sh, sh), (1, 2))
            out.append(a)
        return out


def nearest_idx(n_out: int, n_in: int) -> np.ndarray:
    """Source index of each output position of a 1-D nearest resize, as
    `jax.image.resize(..., "nearest")` picks it: the half-pixel floor rule
    floor((i + 0.5) * n_in / n_out), which is 2i + 1 on an exact halving
    and i // 2 on an exact doubling (`torch`'s "nearest" mode differs)."""
    return np.floor((np.arange(n_out) + 0.5) * n_in / n_out).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _idx_tensor(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    # made once per size pair: a fresh host-to-device copy each call would
    # wait for the stream; outside inference mode, so that a later call
    # under autograd may use the same tensor
    with torch.inference_mode(False):
        return torch.as_tensor(nearest_idx(n_out, n_in), device=device)


def nearest_resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C) by `nearest_idx` along each axis."""
    for axis, n_out in ((1, hw[0]), (2, hw[1])):
        n_in = x.shape[axis]
        if n_in != n_out:
            x = x.index_select(axis, _idx_tensor(n_out, n_in, x.device))
    return x


class CrossLevelFusion(nn.Module):
    """Each level plus its 1x1-projected resized neighbours (the next
    coarser through `up`, the next finer through `down`), then a LayerNorm
    per level: the JAX package's "perlevel" fusion."""

    def __init__(self, d_model: int, n_levels: int):
        super().__init__()
        self.up = nn.ModuleDict({str(i): nn.Linear(d_model, d_model)
                                 for i in range(n_levels - 1)})
        self.down = nn.ModuleDict({str(i): nn.Linear(d_model, d_model)
                                   for i in range(1, n_levels)})
        self.norm = nn.ModuleList(nn.LayerNorm(d_model, eps=LN_EPS)
                                  for _ in range(n_levels))

    def forward(self, levels: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for i, x in enumerate(levels):
            hw = x.shape[1:3]
            acc = x
            if i + 1 < len(levels):
                up = self.up[str(i)]
                acc = acc + dense(nearest_resize(levels[i + 1], hw),
                                  up.weight, up.bias)
            if i > 0:
                down = self.down[str(i)]
                acc = acc + dense(nearest_resize(levels[i - 1], hw),
                                  down.weight, down.bias)
            out.append(self.norm[i](acc))
        return out


class WindowedEncoder(nn.Module):
    """Drop-in encoder over one frame's levels -> (B, S, C) memory in the
    deformable encoder's token order. Checkpoint keys:
    `layers.{i}.{self_attn,norm1,linear1,linear2,norm2}` and
    `fuse.{i}.{up,down,norm}.{j}`."""

    def __init__(self, d_model: int, n_levels: int, num_layers: int,
                 nheads: int, dim_feedforward: int, window: int,
                 dropout: float = 0.0):
        super().__init__()
        self.window = window
        self.layers = nn.ModuleList(
            WindowedEncoderLayer(d_model, nheads, dim_feedforward, window,
                                 shift=bool(li % 2), dropout=dropout)
            for li in range(num_layers))
        self.fuse = nn.ModuleList(CrossLevelFusion(d_model, n_levels)
                                  for _ in range(num_layers))

    def forward(self, srcs: Sequence[torch.Tensor],
                masks: Sequence[torch.Tensor],
                poses: Sequence[torch.Tensor]) -> torch.Tensor:
        """srcs (B, C, H_l, W_l); masks (B, H_l, W_l) True = pad; poses
        (B, H_l, W_l, C) with the level embeds added."""
        levels = [s.permute(0, 2, 3, 1) for s in srcs]
        dtype = levels[0].dtype
        ctxs = {shift: window_context(poses, masks, self.window, shift, dtype)
                for shift in {layer.shift for layer in self.layers}}
        for layer, fuse in zip(self.layers, self.fuse):
            levels = fuse(layer(levels, ctxs[layer.shift]))
        b, c = levels[0].shape[0], levels[0].shape[-1]
        return torch.cat([x.reshape(b, -1, c) for x in levels], 1)
