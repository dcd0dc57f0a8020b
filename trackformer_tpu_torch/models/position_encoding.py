"""Sine positional encodings (2-D, and 3-D with a frame axis), and the
learned row / column embedding.

Counterpart of `trackformer_tpu/models/position_encoding.py`. Sine values
come from cumulative sums of the pad mask, so padding does not shift the
phase. Outputs keep the JAX package's channels-last layout. As in the JAX
package, no model uses `LearnedPositionEncoding`: `position_embedding:
learned` builds the sine model there and here.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _dim_t(num_pos_feats: int, temperature: float,
           device: torch.device) -> torch.Tensor:
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)


def _interleave_sin_cos(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                       dim=-1).flatten(-2)


def sine_position_encoding(mask: torch.Tensor, num_pos_feats: int,
                           temperature: float = 10000.0,
                           scale: float = 2 * math.pi,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """(B, H, W) pad mask -> (B, H, W, 2 * num_pos_feats)
    (PositionEmbeddingSine with normalize=True)."""
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    eps = 1e-6
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = _dim_t(num_pos_feats, temperature, mask.device)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)


def sine_position_encoding_3d(mask: torch.Tensor, num_pos_feats: int,
                              num_frames: int = 2,
                              temperature: float = 10000.0,
                              scale: float = 2 * math.pi,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Frame-aware sine embedding -> (B, F, H, W, 3 * num_pos_feats); as in
    the JAX package, the 3-D variant normalizes without the -0.5 shift."""
    not_mask = (~mask).float()[:, None].repeat(1, num_frames, 1, 1)
    z_embed = not_mask.cumsum(1)
    y_embed = not_mask.cumsum(2)
    x_embed = not_mask.cumsum(3)
    eps = 1e-6
    z_embed = z_embed / (z_embed[:, -1:, :, :] + eps) * scale
    y_embed = y_embed / (y_embed[:, :, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, :, -1:] + eps) * scale
    dim_t = _dim_t(num_pos_feats, temperature, mask.device)
    pos = torch.cat([_interleave_sin_cos(e[..., None] / dim_t)
                     for e in (z_embed, y_embed, x_embed)], dim=-1)
    return pos.to(dtype)


class LearnedPositionEncoding(nn.Module):
    """Learned column and row embeddings of a 50 x 50 grid: (B, H, W) mask
    -> (B, H, W, 2 * num_pos_feats), the column's embedding then the row's
    (the mask's values are not read). Parameters `col_embed.weight` /
    `row_embed.weight` (50, num_pos_feats), the original's keys."""

    def __init__(self, num_pos_feats: int = 256):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.row_embed = nn.Embedding(50, num_pos_feats)
        self.col_embed = nn.Embedding(50, num_pos_feats)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        b, h, w = mask.shape
        f = self.num_pos_feats
        x_emb = self.col_embed.weight[:w][None].expand(h, w, f)
        y_emb = self.row_embed.weight[:h][:, None].expand(h, w, f)
        return torch.cat([x_emb, y_emb], -1)[None].expand(b, h, w, 2 * f)
