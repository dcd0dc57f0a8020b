"""Vanilla DETR transformer: encoder and decoder layers with the post-norm
and pre-norm variants, and the dedicated track-query attention layers.

Counterpart of `trackformer_tpu/models/transformer.py`. Batch-first (B, L,
C) throughout. The decoder returns every layer's output, normed (for the
heads and auxiliary losses) and raw (for `hs_embed`). Parameters sit under
the original checkpoint keys: `encoder.layers.{i}`, `encoder.norm`
(pre-norm), `decoder.layers.{i}`, `decoder.norm` and
`decoder.layers_track_attention.{i}`. The attention is the port's
`MultiHeadAttention` (float32 logits and softmax, as the JAX package's
einsums keep them); every norm takes flax's eps, 1e-6.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import Dropout, MultiHeadAttention, feed_forward

LN_EPS = 1e-6


def with_pos(x: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    return x if pos is None else x + pos


class EncoderLayer(nn.Module):

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiHeadAttention(d_model, nheads, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = Dropout(dropout)

    def forward(self, src, pos=None, key_padding_mask=None):
        drop = self.drop
        if self.pre_norm:
            s2 = self.norm1(src)
            q = with_pos(s2, pos)
            src = src + drop(self.self_attn(q, q, s2, key_padding_mask))
            s2 = feed_forward(self.norm2(src), self.linear1, self.linear2,
                              drop)
            return src + drop(s2)
        q = with_pos(src, pos)
        src = self.norm1(src + drop(self.self_attn(q, q, src,
                                                   key_padding_mask)))
        s2 = feed_forward(src, self.linear1, self.linear2,
                              drop)
        return self.norm2(src + drop(s2))


class DecoderLayer(nn.Module):

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, pre_norm: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = MultiHeadAttention(d_model, nheads, dropout)
        self.multihead_attn = MultiHeadAttention(d_model, nheads, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop = Dropout(dropout)

    def forward(self, tgt, memory, query_pos=None, pos=None,
                tgt_key_padding_mask=None, memory_key_padding_mask=None):
        drop = self.drop
        mem_k = with_pos(memory, pos)
        if self.pre_norm:
            t2 = self.norm1(tgt)
            q = with_pos(t2, query_pos)
            tgt = tgt + drop(self.self_attn(q, q, t2, tgt_key_padding_mask))
            t2 = self.norm2(tgt)
            tgt = tgt + drop(self.multihead_attn(
                with_pos(t2, query_pos), mem_k, memory,
                memory_key_padding_mask))
            t2 = feed_forward(self.norm3(tgt), self.linear1, self.linear2,
                              drop)
            return tgt + drop(t2)
        q = with_pos(tgt, query_pos)
        tgt = self.norm1(tgt + drop(self.self_attn(q, q, tgt,
                                                   tgt_key_padding_mask)))
        tgt = self.norm2(tgt + drop(self.multihead_attn(
            with_pos(tgt, query_pos), mem_k, memory,
            memory_key_padding_mask)))
        t2 = feed_forward(tgt, self.linear1, self.linear2,
                              drop)
        return self.norm3(tgt + drop(t2))


class Encoder(nn.Module):

    def __init__(self, d_model, nheads, num_layers, dim_feedforward, dropout,
                 pre_norm):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nheads, dim_feedforward, dropout, pre_norm)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS) if pre_norm else None


class Decoder(nn.Module):

    def __init__(self, d_model, nheads, num_layers, dim_feedforward, dropout,
                 pre_norm, track_attention):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nheads, dim_feedforward, dropout, pre_norm)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.layers_track_attention = nn.ModuleList(
            EncoderLayer(d_model, nheads, dim_feedforward, dropout, pre_norm)
            for _ in range(num_layers if track_attention else 0))


class Transformer(nn.Module):
    """DETR encoder-decoder over one flattened feature map.

    forward(src (B, H, W, C), mask (B, H, W), query_pos (B, Q, C), pos
    (B, H, W, C), tgt optional (B, Q, C), tgt_key_padding_mask optional
    (B, Q)) -> (hs (L, B, Q, C) normed, hs_raw, memory (B, H, W, C)).
    With `track_attention` the first Q - `num_queries` slots are track
    queries: they keep their positions only inside the track-attention
    layers, which run on them alone before each decoder layer."""

    def __init__(self, d_model: int = 512, nheads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 pre_norm: bool = False, track_attention: bool = False,
                 num_queries: int = 100):
        super().__init__()
        self.pre_norm = pre_norm
        self.track_attention = track_attention
        self.num_queries = num_queries
        self.encoder = Encoder(d_model, nheads, num_encoder_layers,
                               dim_feedforward, dropout, pre_norm)
        self.decoder = Decoder(d_model, nheads, num_decoder_layers,
                               dim_feedforward, dropout, pre_norm,
                               track_attention)

    def forward(self, src, mask, query_pos, pos, tgt=None,
                tgt_key_padding_mask=None):
        b, h, w, c = src.shape
        memory = src.reshape(b, h * w, c)
        pos_t = pos.reshape(b, h * w, c).to(src.dtype)
        mask_t = mask.reshape(b, h * w)
        for layer in self.encoder.layers:
            memory = layer(memory, pos_t, mask_t)
        if self.encoder.norm is not None:
            memory = self.encoder.norm(memory)

        query_pos = query_pos.to(src.dtype)
        if tgt is None:
            tgt = torch.zeros_like(query_pos)
        n_obj = self.num_queries
        if self.track_attention:
            track_query_pos = query_pos[:, :-n_obj]
            query_pos = torch.cat([torch.zeros_like(track_query_pos),
                                   query_pos[:, -n_obj:]], 1)
            track_pad = (None if tgt_key_padding_mask is None
                         else tgt_key_padding_mask[:, :-n_obj])

        inter, inter_raw = [], []
        out = tgt
        for i, layer in enumerate(self.decoder.layers):
            if self.track_attention:
                track_out = self.decoder.layers_track_attention[i](
                    out[:, :-n_obj], track_query_pos, track_pad)
                out = torch.cat([track_out, out[:, -n_obj:]], 1)
            out = layer(out, memory, query_pos, pos_t, tgt_key_padding_mask,
                        mask_t)
            inter.append(self.decoder.norm(out))
            inter_raw.append(out)
        return (torch.stack(inter), torch.stack(inter_raw),
                memory.reshape(b, h, w, c))
