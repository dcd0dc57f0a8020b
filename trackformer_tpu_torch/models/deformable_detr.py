"""Deformable DETR head for online tracking: input projections, the
deformable or windowed encoder, the decoder with or without box refinement,
two-stage query selection, and track-query injection.

Counterpart of `trackformer_tpu/models/deformable_detr.py`:

  * frames: multi-frame attention (the previous and the current frame's
    levels, `total_levels` = 2 x `num_feature_levels`) or a single frame;
    multi-frame positions 3-D (`multi_frame_encoding`) or 2-D; the
    multi-frame encoder run once per frame with shared weights
    (`multi_frame_attention_separate_encoder`) or once over both frames'
    levels; with `merge_frame_features` each backbone level (and the first
    extra one) of a frame is a 1x1 conv over [its projection, the previous
    frame's projection] (`merge_features.{l}`);
  * levels: the last three backbone maps, then stride-2 extra levels up to
    `num_feature_levels` (3 or more: the JAX package passes three maps to
    `_project_frame` whatever the count);
  * encoder: exact MSDA, or the windowed encoder (kernel #8 in eval mode)
    over the levels it is given; and on the multi-frame separate-encoder
    model with `tpu.cached_prev_memory` (the JAX `_cached_mode`, either
    encoder) the current frame only, frame-symmetrically (frame-0
    positions and the first half of the level embeds), the previous step's
    encoded memory reused as the previous half, and a learned
    `frame_embed` restoring frame identity after the encoder. On a single
    frame `tpu_fast` is the windowed encoder over that frame, as in JAX
    (`_cached_mode` is false there);
  * decoder: MSDA or dense cross-attention (`tpu.decoder_attention`); one
    head per layer with box refinement (each layer samples around the
    previous layer's boxes), or one shared class and box head without it
    (the reference points stay the queries' own);
  * two-stage: the encoder's proposals (`enc_output`, the last class and
    box head, an extra one under box refinement) score every memory token;
    the top `num_queries` by the first class logit, lower index first
    among ties, seed the decoder's reference points and, through
    `pos_trans`, its queries; `enc_outputs` carries the proposals for the
    `_enc` losses. As in the JAX package, a two-stage model takes no track
    queries.

A `tpu.scan_layers` model runs the same math unrolled; its weights load
through `utils/checkpoint.py:bridge_scan_layout`. `remat` recomputes each
exact-MSDA encoder layer in a training step's backward, `remat_decoder`
each decoder layer with its heads (the JAX package's `nn.remat` on its
encoder layers and on its decoder's scan body, which exists under
`tpu.scan_layers` only). Positions are sine
(`position_embedding: learned` builds the same model, as in JAX). The
concatenation order is the JAX package's: memory is [cur, prev], while
spatial shapes, masks, positions and valid ratios of the multi-frame model
are built prev frame first.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from ..structures import FrameBatch, Targets
from .attention import remat
from .backbone import BACKBONE_CHANNELS, Backbone, downsample_mask
from .deformable_transformer import (DeformableTransformer,
                                     decoder_reference_input,
                                     gen_encoder_output_proposals,
                                     get_valid_ratio, proposal_pos_embed,
                                     stable_topk_indices)
from .detr import MLP
from .position_encoding import (sine_position_encoding,
                                sine_position_encoding_3d)

GN_EPS = 1e-6


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1.0 - x).clamp(min=eps))


class InputProj(nn.Sequential):
    """1x1 conv (3x3 stride 2 for an extra level) + GroupNorm(32)."""

    def __init__(self, in_channels: int, hidden_dim: int,
                 stride2: bool = False):
        conv = (nn.Conv2d(in_channels, hidden_dim, 3, stride=2, padding=1)
                if stride2 else nn.Conv2d(in_channels, hidden_dim, 1))
        super().__init__(conv, nn.GroupNorm(32, hidden_dim, eps=GN_EPS))


class DeformableDETR(nn.Module):

    def __init__(self, num_classes: int, num_queries: int = 500,
                 hidden_dim: int = 288, nheads: int = 8, enc_layers: int = 6,
                 dec_layers: int = 6, dim_feedforward: int = 1024,
                 num_feature_levels: int = 4, dec_n_points: int = 4,
                 enc_n_points: int = 4, backbone_name: str = "resnet50",
                 dilation: bool = False, aux_loss: bool = True,
                 encoder_window: Optional[int] = None, dropout: float = 0.0,
                 multi_frame: bool = True, multi_frame_encoding: bool = True,
                 separate_encoder: bool = True, cached_memory: bool = True,
                 with_box_refine: bool = True, two_stage: bool = False,
                 merge_frame_features: bool = False,
                 decoder_attention: str = "msda", remat: bool = False,
                 remat_decoder: bool = False):
        """`encoder_window` None: the exact-MSDA encoder; an int: a windowed
        encoder of that window side. `cached_memory` takes effect where the
        model is multi-frame with a separate encoder and unmerged frames
        (the JAX `_cached_mode`). `multi_frame`, `multi_frame_encoding` and
        `separate_encoder` are the config's `multi_frame_attention*`
        switches; `with_box_refine` False shares one class and box head
        across the decoder layers. `dropout` acts in training mode only, in
        either encoder and the decoder."""
        super().__init__()
        if num_feature_levels < 3:
            raise ValueError(f"num_feature_levels {num_feature_levels}: the "
                             f"model takes the last three backbone maps")
        self.multi_frame = multi_frame
        self.frame_pos_3d = multi_frame and multi_frame_encoding
        self.separate_encoder = multi_frame and separate_encoder
        self.merge_frame_features = merge_frame_features
        self.cached_memory = (cached_memory and self.separate_encoder
                              and not merge_frame_features)
        self.windowed = encoder_window is not None
        self.dense_decoder = decoder_attention == "dense"
        self.with_box_refine = with_box_refine
        self.two_stage = two_stage
        self.num_queries = num_queries
        self.hidden_dim = hidden_dim
        self.num_feature_levels = num_feature_levels
        self.dec_layers = dec_layers
        self.aux_loss = aux_loss
        self.remat_decoder = remat_decoder
        total_levels = num_feature_levels * (2 if multi_frame else 1)
        enc_levels = (num_feature_levels if self.separate_encoder
                      else total_levels)
        # index 0 keeps the original checkpoint keys `backbone.0.body.*`
        self.backbone = nn.ModuleList([Backbone(backbone_name, dilation)])
        in_ch = BACKBONE_CHANNELS[-3:]
        projs = [InputProj(in_ch[i], hidden_dim) for i in range(3)]
        for i in range(num_feature_levels - 3):
            projs.append(InputProj(in_ch[-1] if i == 0 else hidden_dim,
                                   hidden_dim, stride2=True))
        self.input_proj = nn.ModuleList(projs)
        if merge_frame_features:
            # the backbone levels and the first extra level merge; the
            # later extra levels come from the merged ones
            self.merge_features = nn.ModuleList(
                nn.Conv2d(2 * hidden_dim, hidden_dim, 1)
                for _ in range(min(4, num_feature_levels)))
        if not two_stage:
            self.query_embed = nn.Embedding(num_queries, 2 * hidden_dim)
        self.transformer = DeformableTransformer(
            hidden_dim, total_levels, enc_levels, enc_layers,
            dec_layers, nheads, enc_n_points, dec_n_points, dim_feedforward,
            encoder_window, dropout, frame_embed=self.cached_memory,
            decoder_attention=decoder_attention, two_stage=two_stage,
            remat=remat)
        # without box refinement one head serves every layer (and the
        # two-stage proposals): index 0, the JAX package's `class_embed_0`
        # / `bbox_embed_0`; with it one per layer, and for two-stage one
        # more for the proposals, the last
        n_heads = (dec_layers + int(two_stage)) if with_box_refine else 1
        self.class_embed = nn.ModuleList(
            nn.Linear(hidden_dim, num_classes + 1) for _ in range(n_heads))
        self.bbox_embed = nn.ModuleList(
            MLP(hidden_dim, hidden_dim, 4, 3) for _ in range(n_heads))

    @property
    def dtype(self) -> torch.dtype:
        return self.transformer.level_embed.dtype

    def _project_frame(self, frame_feats, frame_masks, prev_feats,
                       batch_mask, frame_idx):
        """One frame's three backbone maps -> hidden_dim, merged with the
        previous frame's where `merge_frame_features`, plus extra levels."""
        srcs, masks, poses = [], [], []
        n_bb = len(frame_feats)
        for lvl in range(self.num_feature_levels):
            if lvl <= n_bb:
                src = self.input_proj[lvl](frame_feats[min(lvl, n_bb - 1)])
                if self.merge_frame_features:
                    prev = self.input_proj[lvl](prev_feats[min(lvl,
                                                               n_bb - 1)])
                    src = self.merge_features[lvl](torch.cat([src, prev], 1))
            else:
                src = self.input_proj[lvl](srcs[-1])
            mask = (frame_masks[lvl] if lvl < n_bb
                    else downsample_mask(batch_mask, src.shape[-2:]))
            srcs.append(src)
            masks.append(mask)
            poses.append(self._level_pos(mask, frame_idx))
        return srcs, masks, poses

    def _level_pos(self, mask, frame_idx):
        """3-D sine positions of frame `frame_idx` where the model encodes
        frames, else 2-D (JAX `_level_pos`)."""
        if self.frame_pos_3d:
            return sine_position_encoding_3d(
                mask, self.hidden_dim // 3, num_frames=2,
                dtype=self.dtype)[:, frame_idx]
        return sine_position_encoding(mask, self.hidden_dim // 2,
                                      dtype=self.dtype)

    def _encode_flat(self, srcs, masks, poses, lo, hi):
        """The exact-MSDA encoder over levels lo .. hi - 1 -> memory."""
        shapes = tuple((s.shape[-2], s.shape[-1]) for s in srcs[lo:hi])
        src_flat = torch.cat([s.flatten(2).transpose(1, 2)
                              for s in srcs[lo:hi]], 1)
        mask_flat = torch.cat([m.flatten(1) for m in masks[lo:hi]], 1)
        valid_ratios = torch.stack([get_valid_ratio(m) for m in masks[lo:hi]],
                                   1)
        return self.transformer.encoder(src_flat, shapes, valid_ratios,
                                        self._pos_flat(poses, lo, hi),
                                        mask_flat)

    def _pos_flat(self, poses, lo=0, hi=None):
        """Levels lo .. hi - 1's positions with their level embeds, flat
        (B, S, C): the exact encoder's, and the dense decoder's keys add
        them."""
        level_embed = self.transformer.level_embed
        return torch.cat([(p + level_embed[lo + i]).flatten(1, 2)
                          for i, p in enumerate(poses[lo:hi])], 1)

    def forward(self, batch: FrameBatch, targets: Optional[Targets] = None,
                prev_features=None):
        """-> (out, targets, feature_pairs, memory_slices, hs), as the JAX
        module's `__call__`. `feature_pairs` (NCHW features and their
        masks) is what the next frame takes as `prev_features`; a
        single-frame model reads it only to merge frame features."""
        features, feat_masks = self.backbone[0](batch)
        feature_pairs = list(zip(features, feat_masks))
        cur3, cur3_masks = features[-3:], feat_masks[-3:]
        if prev_features is None:
            prev3, prev3_masks = cur3, cur3_masks
        else:
            prev3 = [p[0] for p in prev_features[-3:]]
            prev3_masks = [p[1] for p in prev_features[-3:]]
        if self.cached_memory:
            return self._forward_cached(batch, targets, prev_features, cur3,
                                        cur3_masks, prev3, feature_pairs)
        frame_sets = ([(prev3, prev3_masks, 0), (cur3, cur3_masks, 1)]
                      if self.multi_frame else [(cur3, cur3_masks, 0)])
        srcs, masks, poses = [], [], []
        for feats_f, masks_f, fidx in frame_sets:
            s, m, p = self._project_frame(feats_f, masks_f, prev3,
                                          batch.mask, fidx)
            srcs += s
            masks += m
            poses += p

        spatial_shapes = tuple((s.shape[-2], s.shape[-1]) for s in srcs)
        mask_flat = torch.cat([m.flatten(1) for m in masks], 1)
        valid_ratios = torch.stack([get_valid_ratio(m) for m in masks], 1)
        level_embed = self.transformer.level_embed
        n_lv = len(spatial_shapes)
        if self.windowed:
            # the windowed encoder: one call per frame of a separate
            # encoder, else one over every level
            poses_wl = [p + level_embed[i] for i, p in enumerate(poses)]

            def encode(lo, hi):
                return self.transformer.encoder(srcs[lo:hi], masks[lo:hi],
                                                poses_wl[lo:hi])
        else:
            def encode(lo, hi):
                return self._encode_flat(srcs, masks, poses, lo, hi)
        if self.separate_encoder:
            # one pass per frame with shared weights; memory [cur, prev]
            prev_memory = encode(0, n_lv // 2)
            memory = torch.cat([encode(n_lv // 2, n_lv), prev_memory], 1)
        else:
            memory = encode(0, n_lv)
        # the dense decoder's key positions, prev frame first as the masks
        pos_flat = self._pos_flat(poses) if self.dense_decoder else None
        return self._decode(batch, targets, memory, spatial_shapes,
                            mask_flat, valid_ratios, feature_pairs, pos_flat)

    def _forward_cached(self, batch, targets, prev_features, cur3,
                        cur3_masks, prev3, feature_pairs):
        """The cached previous memory: encode the current frame only (the
        windowed or the exact encoder); the previous half of the memory is
        `prev_features[-1][0]`, the encoded memory this method appends to
        `feature_pairs` (the current frame's own on the first frame). In
        training the previous frame's forward runs without gradient
        (`tracking_train_forward`), so its memory comes in detached, as the
        JAX package stops its gradient; the current frame's memory carries
        the encoder's gradient."""
        srcs, masks, poses = self._project_frame(cur3, cur3_masks, prev3,
                                                 batch.mask, 0)
        level_embed = self.transformer.level_embed
        half_shapes = tuple((s.shape[-2], s.shape[-1]) for s in srcs)
        mask_half = torch.cat([m.flatten(1) for m in masks], 1)
        vr_half = torch.stack([get_valid_ratio(m) for m in masks], 1)
        if self.windowed:
            cur_memory = self.transformer.encoder(
                srcs, masks, [p + level_embed[i] for i, p in enumerate(poses)])
        else:
            cur_memory = self._encode_flat(srcs, masks, poses, 0, len(srcs))
        prev_memory = (cur_memory if prev_features is None
                       else prev_features[-1][0].to(cur_memory.dtype))
        fe = self.transformer.frame_embed
        memory = torch.cat([cur_memory + fe[1], prev_memory + fe[0]], 1)
        feature_pairs.append((cur_memory, mask_half))
        pos_flat = None
        if self.dense_decoder:
            pos_half = self._pos_flat(poses)
            pos_flat = torch.cat([pos_half, pos_half], 1)
        return self._decode(batch, targets, memory, half_shapes * 2,
                            torch.cat([mask_half, mask_half], 1),
                            torch.cat([vr_half, vr_half], 1), feature_pairs,
                            pos_flat)

    def _queries(self, b, targets, memory, spatial_shapes, mask_flat):
        """The decoder's inputs -> (query_pos, tgt, reference_points,
        query_valid, tgt_key_pad, enc_outputs): the learned queries with
        any track queries in front, or the two-stage proposals."""
        c = self.hidden_dim
        dev = memory.device
        if self.two_stage:
            out_mem, props = gen_encoder_output_proposals(
                memory, mask_flat, spatial_shapes)
            tr = self.transformer
            out_mem = tr.enc_output_norm(tr.enc_output(out_mem))
            enc_logits = self.class_embed[-1](out_mem).float()
            enc_coords = self.bbox_embed[-1](out_mem).float() + props
            idx = stable_topk_indices(enc_logits[..., 0], self.num_queries)
            topk = enc_coords.gather(1, idx[..., None].expand(-1, -1, 4))
            topk = topk.detach()
            pos_trans = tr.pos_trans_norm(tr.pos_trans(
                proposal_pos_embed(topk).to(self.dtype)))
            query_pos, tgt = pos_trans.split(c, -1)
            query_valid = torch.ones(b, self.num_queries, dtype=torch.bool,
                                     device=dev)
            enc_outputs = {"pred_logits": enc_logits,
                           "pred_boxes": enc_coords.sigmoid()}
            return query_pos, tgt, topk.sigmoid(), query_valid, None, \
                enc_outputs
        qe = self.query_embed.weight
        query_pos = qe[None, :, :c].expand(b, -1, -1)
        tgt = qe[None, :, c:].expand(b, -1, -1)
        reference_points = self.transformer.reference_points(
            query_pos).float().sigmoid()
        query_valid = torch.ones(b, self.num_queries, dtype=torch.bool,
                                 device=dev)
        tgt_key_pad = None
        if targets is not None and targets.tq_hs_embeds is not None:
            # track queries: prev-frame embeddings with zero query_pos and
            # their boxes' centres as 2-d reference points
            k = targets.tq_hs_embeds.shape[1]
            query_pos = torch.cat(
                [torch.zeros(b, k, c, dtype=qe.dtype, device=dev),
                 query_pos], 1)
            tgt = torch.cat([targets.tq_hs_embeds.to(qe.dtype), tgt], 1)
            reference_points = torch.cat(
                [targets.tq_boxes[..., :2].float(), reference_points], 1)
            query_valid = torch.cat([targets.tq_valid, query_valid], 1)
            tgt_key_pad = ~query_valid
        return query_pos, tgt, reference_points, query_valid, tgt_key_pad, \
            None

    def _decode(self, batch, targets, memory, spatial_shapes, mask_flat,
                valid_ratios, feature_pairs, pos_flat=None):
        b = batch.batch_size
        c = self.hidden_dim
        (query_pos, out_t, reference_points, query_valid, tgt_key_pad,
         enc_outputs) = self._queries(b, targets, memory, spatial_shapes,
                                      mask_flat)

        def layer_step(i, layer, out_t, reference_points):
            ref_input = decoder_reference_input(reference_points,
                                                valid_ratios)
            out_t = layer(out_t, query_pos, ref_input, memory,
                          spatial_shapes, mask_flat, tgt_key_pad, pos_flat)
            head = i if self.with_box_refine else 0
            cls_i = self.class_embed[head](out_t).float()
            tmp = self.bbox_embed[head](out_t).float()
            if reference_points.shape[-1] == 4:
                tmp = tmp + inverse_sigmoid(reference_points)
            else:
                tmp = torch.cat([tmp[..., :2]
                                 + inverse_sigmoid(reference_points),
                                 tmp[..., 2:]], -1)
            return out_t, cls_i, tmp.sigmoid()

        recompute = (self.remat_decoder and self.training
                     and torch.is_grad_enabled())
        classes, coords, hs_list = [], [], []
        for i, layer in enumerate(self.transformer.decoder.layers):
            step = functools.partial(layer_step, i, layer)
            out_t, cls_i, coord_i = (
                remat(step, layer, out_t, reference_points) if recompute
                else step(out_t, reference_points))
            if self.with_box_refine:
                # the next layer samples around this layer's box
                reference_points = coord_i.detach()
            classes.append(cls_i)
            coords.append(coord_i)
            hs_list.append(out_t)

        hs = torch.stack(hs_list)
        out = {"pred_logits": classes[-1], "pred_boxes": coords[-1],
               "hs_embed": hs[-1].float(), "query_valid": query_valid}
        if self.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": classes[i], "pred_boxes": coords[i],
                 "query_valid": query_valid}
                for i in range(self.dec_layers - 1)]
        if enc_outputs is not None:
            out["enc_outputs"] = enc_outputs
        memory_slices = []
        offset = 0
        for h, w in spatial_shapes:
            memory_slices.append(
                memory[:, offset:offset + h * w].reshape(b, h, w, c))
            offset += h * w
        return out, targets, feature_pairs, memory_slices, hs
