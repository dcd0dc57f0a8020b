"""Deformable transformer: the MSDA module, encoder layers and stack,
decoder layer (MSDA or dense cross-attention), reference points, valid
ratios and the two-stage proposals.

Counterpart of `trackformer_tpu/models/deformable_transformer.py`. As
there, the decoder loop with box refinement lives in the DeformableDETR
head. `DeformableTransformer` here only groups the parameters under the
original checkpoint keys (`transformer.level_embed`,
`transformer.encoder.layers.{i}`, `transformer.decoder.layers.{i}`,
`transformer.reference_points`, or for two-stage `transformer.enc_output`,
`transformer.enc_output_norm`, `transformer.pos_trans`,
`transformer.pos_trans_norm`). Every norm takes its eps explicitly: the
JAX package uses flax's 1e-6. Dropout sits where the JAX layers put it
(after each attention and the FFN, inside the FFN and on the self-attention
weights) and is inactive in `eval()`. With `remat` the encoder runs each
layer of a training forward that records gradients under `remat`
(its activations recomputed in the backward, the dropout masks replayed).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.msda import ms_deform_attn
from ..parallel import tp as tensor_parallel
from .attention import Dropout, MultiHeadAttention, feed_forward, remat
from .windowed_encoder import WindowedEncoder

LN_EPS = 1e-6
# sine features per box coordinate of a two-stage proposal
PROPOSAL_POS_FEATS = 128


@functools.lru_cache(maxsize=16)
def _shapes_tensor(spatial_shapes: Tuple[Tuple[int, int], ...],
                   device: torch.device) -> torch.Tensor:
    """(L, 2) float32 level shapes on `device`, made once per shape set: a
    fresh host-to-device copy each call would wait for the stream. Made
    outside inference mode, whoever calls first: a training step after a
    tracker run takes the same tensor into its graph."""
    with torch.inference_mode(False):
        return torch.tensor(spatial_shapes, dtype=torch.float32,
                            device=device)


class MSDeformAttnModule(nn.Module):
    """Projections and sampling around the MSDA core op."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.head_dim = d_model // n_heads
        self.sampling_offsets = nn.Linear(d_model,
                                          n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model,
                                           n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                src: torch.Tensor, spatial_shapes: Tuple[Tuple[int, int], ...],
                src_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """query (B, Lq, C); reference_points (B, Lq, L, 2|4) in [0, 1];
        src (B, S, C); src_padding_mask (B, S) True = pad."""
        b, lq, _ = query.shape
        s = src.shape[1]
        m, l, p = self.n_heads, self.n_levels, self.n_points
        d = self.head_dim

        # under tensor parallelism m is this rank's heads; every input of
        # the head-local part enters the region
        src, query, reference_points = (
            tensor_parallel.enter(x, self)
            for x in (src, query, reference_points))
        value = self.value_proj(src)
        if src_padding_mask is not None:
            value = value.masked_fill(src_padding_mask[..., None], 0.0)
        value = value.view(b, s, m, d)

        offsets = self.sampling_offsets(query).view(b, lq, m, l, p, 2)
        attn = self.attention_weights(query).view(b, lq, m, l * p)
        attn = attn.softmax(-1).view(b, lq, m, l, p)

        # offsets are normalized by (H, W), not (W, H): the original
        # checkpoints embody that convention
        shapes_hw = _shapes_tensor(spatial_shapes, query.device)
        if reference_points.shape[-1] == 2:
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / shapes_hw[None, None, None, :, None, :])
        else:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / p * reference_points[:, :, None, :, None, 2:]
                   * 0.5)
        out = ms_deform_attn(value, spatial_shapes, loc.float(), attn.float())
        return tensor_parallel.row_linear(out.to(query.dtype),
                                          self.output_proj)


class DeformableEncoderLayer(nn.Module):

    def __init__(self, d_model: int, n_levels: int, n_heads: int,
                 n_points: int, dim_feedforward: int, dropout: float = 0.0):
        super().__init__()
        self.self_attn = MSDeformAttnModule(d_model, n_levels, n_heads,
                                            n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = Dropout(dropout)

    def forward(self, src, pos, reference_points, spatial_shapes,
                padding_mask=None):
        drop = self.drop
        src2 = self.self_attn(src + pos if pos is not None else src,
                              reference_points, src, spatial_shapes,
                              padding_mask)
        src = self.norm1(src + drop(src2))
        return self.norm2(src + drop(feed_forward(src, self.linear1,
                                                  self.linear2, drop)))


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """Token-centre grid normalized by the valid extent -> (B, S, L, 2)."""
    refs = []
    dev = valid_ratios.device
    for lvl, (h, w) in enumerate(spatial_shapes):
        ref_y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)
        ref_x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)
        ref_y = ref_y[:, None].expand(h, w).reshape(-1)
        ref_x = ref_x[None, :].expand(h, w).reshape(-1)
        ry = ref_y[None] / (valid_ratios[:, None, lvl, 1] * h)
        rx = ref_x[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], -1))
    reference_points = torch.cat(refs, dim=1)
    return reference_points[:, :, None] * valid_ratios[:, None]


class DeformableEncoder(nn.Module):

    def __init__(self, d_model: int, n_levels: int, num_layers: int,
                 n_heads: int, n_points: int, dim_feedforward: int,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(d_model, n_levels, n_heads, n_points,
                                   dim_feedforward, dropout)
            for _ in range(num_layers))

    def forward(self, src, spatial_shapes, valid_ratios, pos=None,
                padding_mask=None):
        reference_points = encoder_reference_points(spatial_shapes,
                                                    valid_ratios)
        recompute = self.remat and self.training and torch.is_grad_enabled()
        out = src
        for layer in self.layers:
            args = (out, pos, reference_points, spatial_shapes, padding_mask)
            out = remat(layer, layer, *args) if recompute else layer(*args)
        return out


class DeformableDecoderLayer(nn.Module):
    """Self-attention, cross-attention and FFN. `attention` "msda" samples
    the memory around the reference points; "dense" attends every memory
    token (the JAX package's `tpu.decoder_attention: dense`), keys = memory
    + its positions, with the memory's padding masked."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int,
                 n_points: int, dim_feedforward: int, dropout: float = 0.0,
                 attention: str = "msda"):
        super().__init__()
        self.dense = attention == "dense"
        self.drop = Dropout(dropout)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = (MultiHeadAttention(d_model, n_heads, dropout)
                           if self.dense else
                           MSDeformAttnModule(d_model, n_levels, n_heads,
                                              n_points))
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                src_padding_mask=None, tgt_key_padding_mask=None,
                src_pos=None):
        """reference_points are already valid-ratio scaled (B, Q, L, 2|4);
        `src_pos` (B, S, C), the memory's positions, serves the dense
        cross-attention alone."""
        drop = self.drop
        q = k = tgt + query_pos
        tgt = self.norm2(tgt + drop(self.self_attn(q, k, tgt,
                                                   tgt_key_padding_mask)))
        if self.dense:
            keys = src if src_pos is None else src + src_pos.to(src.dtype)
            t2 = self.cross_attn(tgt + query_pos, keys, src,
                                 src_padding_mask)
        else:
            t2 = self.cross_attn(tgt + query_pos, reference_points, src,
                                 spatial_shapes, src_padding_mask)
        tgt = self.norm1(tgt + drop(t2))
        return self.norm3(tgt + drop(feed_forward(tgt, self.linear1,
                                                  self.linear2, drop)))


class DeformableDecoder(nn.Module):
    """Holds the decoder layers; the refinement loop is in DeformableDETR."""

    def __init__(self, d_model: int, n_levels: int, num_layers: int,
                 n_heads: int, n_points: int, dim_feedforward: int,
                 dropout: float = 0.0, attention: str = "msda"):
        super().__init__()
        self.layers = nn.ModuleList(
            DeformableDecoderLayer(d_model, n_levels, n_heads, n_points,
                                   dim_feedforward, dropout, attention)
            for _ in range(num_layers))


class DeformableTransformer(nn.Module):
    """Parameter group under the original `transformer.*` keys. With
    `encoder_window` the encoder is the TPU-fast `WindowedEncoder` of that
    window side; with `frame_embed` a (2, C) `frame_embed` restores frame
    identity to the cached memory (keys the original has not;
    `convert.py`). With `two_stage` the queries come from the encoder's
    proposals (`enc_output*`, `pos_trans*`) and there is no
    `reference_points`. `remat` recomputes the exact-MSDA encoder's layers
    in the backward (not the windowed encoder's, as in JAX)."""

    def __init__(self, d_model: int, total_levels: int, enc_levels: int,
                 enc_layers: int, dec_layers: int, n_heads: int,
                 enc_n_points: int, dec_n_points: int, dim_feedforward: int,
                 encoder_window: Optional[int] = None, dropout: float = 0.0,
                 frame_embed: bool = False, decoder_attention: str = "msda",
                 two_stage: bool = False, remat: bool = False):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(total_levels, d_model))
        if encoder_window is None:
            self.encoder = DeformableEncoder(d_model, enc_levels, enc_layers,
                                             n_heads, enc_n_points,
                                             dim_feedforward, dropout, remat)
        else:
            self.encoder = WindowedEncoder(d_model, enc_levels, enc_layers,
                                           n_heads, dim_feedforward,
                                           encoder_window, dropout)
        if frame_embed:
            self.frame_embed = nn.Parameter(torch.empty(2, d_model))
        self.decoder = DeformableDecoder(d_model, total_levels, dec_layers,
                                         n_heads, dec_n_points,
                                         dim_feedforward, dropout,
                                         decoder_attention)
        if two_stage:
            self.enc_output = nn.Linear(d_model, d_model)
            self.enc_output_norm = nn.LayerNorm(d_model, eps=LN_EPS)
            # over `proposal_pos_embed`'s 4 x 128 features, whatever C
            self.pos_trans = nn.Linear(4 * PROPOSAL_POS_FEATS, 2 * d_model)
            self.pos_trans_norm = nn.LayerNorm(2 * d_model, eps=LN_EPS)
        else:
            self.reference_points = nn.Linear(d_model, 2)


def get_valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) pad mask -> (B, 2) valid fraction of (w, h)."""
    _, h, w = mask.shape
    valid_h = (~mask[:, :, 0]).sum(1).float()
    valid_w = (~mask[:, 0, :]).sum(1).float()
    return torch.stack([valid_w / w, valid_h / h], -1)


def decoder_reference_input(reference_points: torch.Tensor,
                            valid_ratios: torch.Tensor) -> torch.Tensor:
    """Scale (B, Q, 2|4) reference points by the per-level valid ratios
    -> (B, Q, L, 2|4)."""
    if reference_points.shape[-1] == 4:
        vr = torch.cat([valid_ratios, valid_ratios], -1)
    else:
        vr = valid_ratios
    return reference_points[:, :, None] * vr[:, None]


def proposal_pos_embed(proposals: torch.Tensor,
                       num_pos_feats: int = PROPOSAL_POS_FEATS,
                       temperature: float = 10000.0) -> torch.Tensor:
    """Sine embedding of unactivated two-stage proposal boxes: (B, Q, 4)
    -> (B, Q, 4 * num_pos_feats) float32."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=proposals.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos = proposals.float().sigmoid() * (2 * math.pi)
    pos = pos[..., None] / dim_t
    pos = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], -1)
    return pos.reshape(*proposals.shape[:2], -1)


def gen_encoder_output_proposals(memory: torch.Tensor,
                                 memory_padding_mask: torch.Tensor,
                                 spatial_shapes: Sequence[Tuple[int, int]]
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-stage proposal grid -> (memory, proposals (B, S, 4) float32,
    unactivated): a box of side 0.05 * 2^level at each token's centre of
    the valid region; +inf, and the memory zeroed, on padded tokens and on
    proposals outside (0.01, 0.99). The caller applies `enc_output`."""
    b = memory.shape[0]
    dev = memory.device
    proposals, offset = [], 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        mask_l = memory_padding_mask[:, offset:offset + h * w].view(b, h, w)
        valid_h = (~mask_l[:, :, 0]).sum(1).float()
        valid_w = (~mask_l[:, 0, :]).sum(1).float()
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=dev),
                                torch.arange(w, dtype=torch.float32,
                                             device=dev), indexing="ij")
        grid = torch.stack([gx, gy], -1)
        scale = torch.stack([valid_w, valid_h], -1).view(b, 1, 1, 2)
        grid = (grid[None] + 0.5) / scale
        wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
        proposals.append(torch.cat([grid, wh], -1).view(b, -1, 4))
        offset += h * w
    out = torch.cat(proposals, 1)
    valid = ((out > 0.01) & (out < 0.99)).all(-1, keepdim=True)
    out = torch.log(out / (1.0 - out))
    drop = memory_padding_mask[..., None] | ~valid
    out = out.masked_fill(drop, float("inf"))
    return memory.masked_fill(drop, 0.0), out


def stable_topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the `k` largest of each row of `scores` (B, S), the
    lower index first among equal values, as `jax.lax.top_k` orders them:
    a stable descending sort, whose tie order `torch.topk` does not
    promise."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]
