"""Deformable DETR head for online tracking: input projections, the
deformable or windowed encoder, the decoder with or without box refinement,
and track-query injection.

Counterpart of `trackformer_tpu/models/deformable_detr.py` for these
configurations:

  * frames: multi-frame attention (the previous and the current frame's
    levels, `total_levels` = 2 x `num_feature_levels`) or a single frame;
    multi-frame positions 3-D (`multi_frame_encoding`) or 2-D; the
    multi-frame encoder run once per frame with shared weights
    (`multi_frame_attention_separate_encoder`) or once over both frames'
    levels;
  * encoder: exact MSDA, or the windowed encoder (kernel #8 in eval mode)
    over the levels it is given, or the TPU-fast cached mode
    (`cfgs/tpu_fast.yaml` on the multi-frame separate-encoder model): the
    windowed encoder on the current frame only, frame-symmetrically
    (frame-0 positions and the first half of the level embeds), the
    previous step's encoded memory reused as the previous half, and a
    learned `frame_embed` restoring frame identity after the encoder. On a
    single frame `tpu_fast` is the windowed encoder over that frame, as in
    JAX (`_cached_mode` is false there);
  * decoder heads: one per layer with box refinement (each layer samples
    around the previous layer's boxes), or one shared class and box head
    without it (the reference points stay the queries' own).

No two-stage, no merged frame features, no learned positions. A
`tpu.scan_layers` model runs the same math unrolled; its weights load
through `utils/checkpoint.py:bridge_scan_layout`. The concatenation order
is the JAX package's: memory is [cur, prev], while spatial shapes, masks,
positions and valid ratios of the multi-frame model are built prev frame
first.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..structures import FrameBatch, Targets
from .backbone import BACKBONE_CHANNELS, Backbone, downsample_mask
from .deformable_transformer import (DeformableTransformer,
                                     decoder_reference_input,
                                     get_valid_ratio)
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
                 with_box_refine: bool = True):
        """`encoder_window` None: the exact-MSDA encoder; an int: a windowed
        encoder of that window side, with the cached previous memory where
        `cached_memory` and the model is multi-frame with a separate
        encoder (the JAX `_cached_mode`). `multi_frame`,
        `multi_frame_encoding` and `separate_encoder` are the config's
        `multi_frame_attention*` switches; `with_box_refine` False shares
        one class and box head across the decoder layers. `dropout` acts
        in training mode only, in either encoder and the decoder."""
        super().__init__()
        self.multi_frame = multi_frame
        self.frame_pos_3d = multi_frame and multi_frame_encoding
        self.separate_encoder = multi_frame and separate_encoder
        self.cached_memory = (encoder_window is not None and cached_memory
                              and self.separate_encoder)
        self.windowed = encoder_window is not None
        self.with_box_refine = with_box_refine
        self.num_queries = num_queries
        self.hidden_dim = hidden_dim
        self.num_feature_levels = num_feature_levels
        self.dec_layers = dec_layers
        self.aux_loss = aux_loss
        total_levels = num_feature_levels * (2 if multi_frame else 1)
        enc_levels = (num_feature_levels if self.separate_encoder
                      else total_levels)
        # index 0 keeps the original checkpoint keys `backbone.0.body.*`
        self.backbone = nn.ModuleList([Backbone(backbone_name, dilation)])
        n_bb = min(3, num_feature_levels)
        in_ch = BACKBONE_CHANNELS[-n_bb:]
        projs = [InputProj(in_ch[i], hidden_dim) for i in range(n_bb)]
        for i in range(num_feature_levels - n_bb):
            projs.append(InputProj(in_ch[-1] if i == 0 else hidden_dim,
                                   hidden_dim, stride2=True))
        self.input_proj = nn.ModuleList(projs)
        self.query_embed = nn.Embedding(num_queries, 2 * hidden_dim)
        self.transformer = DeformableTransformer(
            hidden_dim, total_levels, enc_levels, enc_layers,
            dec_layers, nheads, enc_n_points, dec_n_points, dim_feedforward,
            encoder_window, dropout, frame_embed=self.cached_memory)
        # without box refinement one head serves every layer: index 0, the
        # JAX package's `class_embed_0` / `bbox_embed_0`
        n_heads = dec_layers if with_box_refine else 1
        self.class_embed = nn.ModuleList(
            nn.Linear(hidden_dim, num_classes + 1) for _ in range(n_heads))
        self.bbox_embed = nn.ModuleList(
            MLP(hidden_dim, hidden_dim, 4, 3) for _ in range(n_heads))

    @property
    def dtype(self) -> torch.dtype:
        return self.query_embed.weight.dtype

    def _project_frame(self, frame_feats, frame_masks, batch_mask,
                       frame_idx):
        """One frame's backbone levels -> hidden_dim, plus extra levels."""
        srcs, masks, poses = [], [], []
        n_bb = len(frame_feats)
        for lvl in range(self.num_feature_levels):
            if lvl < n_bb:
                src = self.input_proj[lvl](frame_feats[lvl])
                mask = frame_masks[lvl]
            else:
                src = self.input_proj[lvl](
                    frame_feats[-1] if lvl == n_bb else srcs[-1])
                mask = downsample_mask(batch_mask, src.shape[-2:])
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

    def forward(self, batch: FrameBatch, targets: Optional[Targets] = None,
                prev_features=None):
        """-> (out, targets, feature_pairs, memory_slices, hs), as the JAX
        module's `__call__`. `feature_pairs` (NCHW features and their
        masks) is what the next frame takes as `prev_features`; a
        single-frame model ignores `prev_features`."""
        features, feat_masks = self.backbone[0](batch)
        feature_pairs = list(zip(features, feat_masks))
        cur3, cur3_masks = features[-3:], feat_masks[-3:]
        if self.cached_memory:
            return self._forward_cached(batch, targets, prev_features, cur3,
                                        cur3_masks, feature_pairs)
        if not self.multi_frame:
            frame_sets = [(cur3, cur3_masks, 0)]
        else:
            if prev_features is None:
                prev3, prev3_masks = cur3, cur3_masks
            else:
                prev3 = [p[0] for p in prev_features[-3:]]
                prev3_masks = [p[1] for p in prev_features[-3:]]
            frame_sets = [(prev3, prev3_masks, 0), (cur3, cur3_masks, 1)]

        srcs, masks, poses = [], [], []
        for feats_f, masks_f, fidx in frame_sets:
            s, m, p = self._project_frame(feats_f, masks_f, batch.mask, fidx)
            srcs += s
            masks += m
            poses += p

        level_embed = self.transformer.level_embed
        poses = [p + level_embed[i] for i, p in enumerate(poses)]
        spatial_shapes = tuple((s.shape[-2], s.shape[-1]) for s in srcs)
        mask_flat = torch.cat([m.flatten(1) for m in masks], 1)
        valid_ratios = torch.stack([get_valid_ratio(m) for m in masks], 1)
        encoder = self.transformer.encoder
        if self.windowed:
            # the windowed encoder without the cached memory: one call per
            # frame of a separate encoder, else one over every level
            def encode(lo, hi):
                return encoder(srcs[lo:hi], masks[lo:hi], poses[lo:hi])
        else:
            src_flat = torch.cat([s.flatten(2).transpose(1, 2)
                                  for s in srcs], 1)
            pos_flat = torch.cat([p.flatten(1, 2) for p in poses], 1)
            starts = [0]
            for h, w in spatial_shapes:
                starts.append(starts[-1] + h * w)

            def encode(lo, hi):
                t0, t1 = starts[lo], starts[hi]
                return encoder(src_flat[:, t0:t1], spatial_shapes[lo:hi],
                               valid_ratios[:, lo:hi], pos_flat[:, t0:t1],
                               mask_flat[:, t0:t1])
        n_lv = len(spatial_shapes)
        if self.separate_encoder:
            # one pass per frame with shared weights; memory [cur, prev]
            prev_memory = encode(0, n_lv // 2)
            memory = torch.cat([encode(n_lv // 2, n_lv), prev_memory], 1)
        else:
            memory = encode(0, n_lv)
        return self._decode(batch, targets, memory, spatial_shapes,
                            mask_flat, valid_ratios, feature_pairs)

    def _forward_cached(self, batch, targets, prev_features, cur3,
                        cur3_masks, feature_pairs):
        """The TPU-fast mode: encode the current frame only; the previous
        half of the memory is `prev_features[-1][0]`, the encoded memory
        this method appends to `feature_pairs` (the current frame's own on
        the first frame). In training the previous frame's forward runs
        without gradient (`tracking_train_forward`), so its memory comes in
        detached, as the JAX package stops its gradient; the current
        frame's memory carries the encoder's gradient."""
        srcs, masks, poses = self._project_frame(cur3, cur3_masks, batch.mask,
                                                 0)
        level_embed = self.transformer.level_embed
        half_shapes = tuple((s.shape[-2], s.shape[-1]) for s in srcs)
        mask_half = torch.cat([m.flatten(1) for m in masks], 1)
        vr_half = torch.stack([get_valid_ratio(m) for m in masks], 1)
        cur_memory = self.transformer.encoder(
            srcs, masks, [p + level_embed[i] for i, p in enumerate(poses)])
        prev_memory = (cur_memory if prev_features is None
                       else prev_features[-1][0].to(cur_memory.dtype))
        fe = self.transformer.frame_embed
        memory = torch.cat([cur_memory + fe[1], prev_memory + fe[0]], 1)
        feature_pairs.append((cur_memory, mask_half))
        return self._decode(batch, targets, memory, half_shapes * 2,
                            torch.cat([mask_half, mask_half], 1),
                            torch.cat([vr_half, vr_half], 1), feature_pairs)

    def _decode(self, batch, targets, memory, spatial_shapes, mask_flat,
                valid_ratios, feature_pairs):
        b = batch.batch_size
        c = self.hidden_dim
        qe = self.query_embed.weight
        query_pos = qe[None, :, :c].expand(b, -1, -1)
        tgt = qe[None, :, c:].expand(b, -1, -1)
        reference_points = self.transformer.reference_points(
            query_pos).float().sigmoid()
        query_valid = torch.ones(b, self.num_queries, dtype=torch.bool,
                                 device=qe.device)
        tgt_key_pad = None
        if targets is not None and targets.tq_hs_embeds is not None:
            # track queries: prev-frame embeddings with zero query_pos and
            # their boxes' centres as 2-d reference points
            k = targets.tq_hs_embeds.shape[1]
            query_pos = torch.cat(
                [torch.zeros(b, k, c, dtype=qe.dtype, device=qe.device),
                 query_pos], 1)
            tgt = torch.cat([targets.tq_hs_embeds.to(qe.dtype), tgt], 1)
            reference_points = torch.cat(
                [targets.tq_boxes[..., :2].float(), reference_points], 1)
            query_valid = torch.cat([targets.tq_valid, query_valid], 1)
            tgt_key_pad = ~query_valid

        out_t = tgt
        classes, coords, hs_list = [], [], []
        for i, layer in enumerate(self.transformer.decoder.layers):
            ref_input = decoder_reference_input(reference_points,
                                                valid_ratios)
            out_t = layer(out_t, query_pos, ref_input, memory,
                          spatial_shapes, mask_flat, tgt_key_pad)
            head = i if self.with_box_refine else 0
            cls_i = self.class_embed[head](out_t).float()
            tmp = self.bbox_embed[head](out_t).float()
            if reference_points.shape[-1] == 4:
                tmp = tmp + inverse_sigmoid(reference_points)
            else:
                tmp = torch.cat([tmp[..., :2]
                                 + inverse_sigmoid(reference_points),
                                 tmp[..., 2:]], -1)
            coord_i = tmp.sigmoid()
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
        memory_slices = []
        offset = 0
        for h, w in spatial_shapes:
            memory_slices.append(
                memory[:, offset:offset + h * w].reshape(b, h, w, c))
            offset += h * w
        return out, targets, feature_pairs, memory_slices, hs
