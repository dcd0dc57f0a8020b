"""DETR heads and the vanilla DETR model with track queries.

Counterpart of `trackformer_tpu/models/detr.py`: the `MLP` box head,
`build_decoder_inputs` and `DETR` (a ResNet backbone, a 1x1 input
projection of its last level, the DETR transformer and the class and box
heads). Track queries occupy a fixed prefix of K slots with a validity
mask: their previous-frame embeddings are decoder targets with zero
positions, invalid slots are excluded from the decoder's self-attention
keys and flagged in `query_valid`. The class and box heads are single
modules (`class_embed`, `bbox_embed.layers.{j}`), as in the original
checkpoints. `AttentionMapDETR` adds the last decoder layer's attention
maps to the outputs (the track CLI's `generate_attention_maps`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..structures import FrameBatch, Targets
from .backbone import Backbone
from .position_encoding import sine_position_encoding
from .transformer import Transformer


class MLP(nn.Module):
    """ReLU MLP; `layers.{i}` match the original checkpoint keys."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def build_decoder_inputs(targets: Optional[Targets],
                         query_embed: torch.Tensor, batch_size: int):
    """-> (query_pos, tgt, tgt_key_padding_mask, query_valid). Track-query
    slots (the prefix) carry the previous frame's embeddings as targets
    with zero positions; the object queries follow with zero targets."""
    q, c = query_embed.shape
    dtype, dev = query_embed.dtype, query_embed.device
    query_pos = query_embed[None].expand(batch_size, q, c)
    if targets is None or targets.tq_hs_embeds is None:
        return (query_pos, None, None,
                torch.ones(batch_size, q, dtype=torch.bool, device=dev))
    k = targets.tq_hs_embeds.shape[1]
    query_pos = torch.cat([torch.zeros(batch_size, k, c, dtype=dtype,
                                       device=dev), query_pos], 1)
    tgt = torch.cat([targets.tq_hs_embeds.to(dtype),
                     torch.zeros(batch_size, q, c, dtype=dtype, device=dev)],
                    1)
    key_pad = torch.cat([~targets.tq_valid,
                         torch.zeros(batch_size, q, dtype=torch.bool,
                                     device=dev)], 1)
    return query_pos, tgt, key_pad, ~key_pad


class DETR(nn.Module):
    """Vanilla DETR with optional track queries. `num_classes` is the head's
    class count (the factory passes the dataset's; the head adds the
    no-object column)."""

    def __init__(self, num_classes: int, num_queries: int = 100,
                 hidden_dim: int = 256, nheads: int = 8, enc_layers: int = 6,
                 dec_layers: int = 6, dim_feedforward: int = 2048,
                 dropout: float = 0.0, pre_norm: bool = False,
                 backbone_name: str = "resnet50", dilation: bool = False,
                 aux_loss: bool = True, track_attention: bool = False):
        super().__init__()
        self.num_queries = num_queries
        self.hidden_dim = hidden_dim
        self.nheads = nheads
        # the backbone's last level (the transformer's memory): C5 at
        # stride 32, at 16 with DC5
        self.stride = 16 if dilation else 32
        self.dec_layers = dec_layers
        self.aux_loss = aux_loss
        # index 0 keeps the original checkpoint keys `backbone.0.body.*`
        self.backbone = nn.ModuleList([Backbone(backbone_name, dilation)])
        self.input_proj = nn.Conv2d(2048, hidden_dim, 1)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.transformer = Transformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward,
            dropout, pre_norm, track_attention, num_queries)
        self.class_embed = nn.Linear(hidden_dim, num_classes + 1)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    @property
    def dtype(self) -> torch.dtype:
        return self.query_embed.weight.dtype

    def forward(self, batch: FrameBatch, targets: Optional[Targets] = None,
                prev_features=None):
        """-> (out, targets, feature_pairs, memory (B, h, w, C), hs (L, B,
        Q, C)), as the JAX module's `__call__`; `prev_features` is
        ignored."""
        features, masks = self.backbone[0](batch)
        src = self.input_proj(features[-1]).permute(0, 2, 3, 1)
        mask = masks[-1]
        pos = sine_position_encoding(mask, self.hidden_dim // 2,
                                     dtype=self.dtype)
        query_pos, tgt, key_pad, query_valid = build_decoder_inputs(
            targets, self.query_embed.weight, batch.batch_size)
        hs, hs_raw, memory = self.transformer(src, mask, query_pos, pos, tgt,
                                              key_pad)
        classes = self.class_embed(hs).float()
        coords = self.bbox_embed(hs).float().sigmoid()
        out = {"pred_logits": classes[-1], "pred_boxes": coords[-1],
               "hs_embed": hs_raw[-1].float(), "query_valid": query_valid}
        if self.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": classes[i], "pred_boxes": coords[i],
                 "query_valid": query_valid}
                for i in range(self.dec_layers - 1)]
        return out, targets, list(zip(features, masks)), memory, hs


class AttentionMapDETR(nn.Module):
    """A vanilla `DETR` (or `DETRSegm`) whose outputs also carry
    "attention_maps" (B, Q, h, w): the last decoder layer's cross-attention
    weights, averaged over the heads in float32 before dropout, over the
    memory's h x w tokens (the JAX track CLI's `generate_attention_maps`,
    read from the weights its attention sows). `stride` is the memory's
    stride in the padded frame (`tracking/tracker.py:attn_hw_of`)."""

    def __init__(self, model: DETR):
        super().__init__()
        if not isinstance(model, DETR):
            raise ValueError("attention maps are only available for vanilla "
                             "DETR, as in the JAX package")
        self.model = model
        self.stride = model.stride

    def forward(self, batch: FrameBatch, targets: Optional[Targets] = None,
                prev_features=None):
        attn = self.model.transformer.decoder.layers[-1].multihead_attn
        attn.keep_weights = True
        try:
            out, targets, feats, memory, hs = self.model(batch, targets,
                                                         prev_features)
            weights = attn.weights
        finally:
            attn.keep_weights, attn.weights = False, None
        b, q, _ = weights.shape
        out["attention_maps"] = weights.reshape(b, q, *memory.shape[1:3])
        return out, targets, feats, memory, hs
