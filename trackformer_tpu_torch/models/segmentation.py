"""Instance segmentation heads of both model families.

Counterpart of `trackformer_tpu/models/segmentation.py`: `MHAttentionMap`
(each query's attention over the encoder memory, softmax over the pixels),
`MaskHeadSmallConv` (the FPN-style convolution head over each query's
attention maps), the shared mask forward that runs after the detector's
(`segm_forward`), `DETRSegm`, `DeformableDETRSegm` and `postprocess_segm`.

The JAX package computes all of this with XLA (einsums and convolutions),
outside Pallas; here it is PyTorch's: `torch.matmul` for the attention map
and cuDNN convolutions on NCHW tensors for the head. The masks come out at
the stride-4 resolution for every query slot; consumers mask them with
`query_valid` and crop and rescale each image on the host.

Where the JAX package's arithmetic is not PyTorch's default it is spelled
out: GroupNorm with flax's eps (1e-6); the head's nearest upsampling at
half-pixel centres (`jax.image.resize`'s "nearest", index floor((i + 0.5)
in / out)), which agrees with `F.interpolate(mode="nearest")` only at
whole ratios; the attention logits and softmax in float32 with padded
pixels at -inf.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from .backbone import BACKBONE_CHANNELS, downsample_mask
from .deformable_detr import DeformableDETR
from .detr import DETR

GN_EPS = 1e-6


class MHAttentionMap(nn.Module):
    """2-D attention map: softmax over the pixels, no value product."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = nn.Linear(hidden_dim, hidden_dim)
        self.k_linear = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q (B, Q, C); k (B, H, W, C); mask (B, H, W) True = padding ->
        (B, Q, heads, H, W), softmax over (H, W), in the model's dtype."""
        b, nq, c = q.shape
        _, h, w, _ = k.shape
        heads, dh = self.num_heads, c // self.num_heads
        qh = self.q_linear(q).reshape(b, nq, heads, dh) * (dh ** -0.5)
        kh = self.k_linear(k).reshape(b, h * w, heads, dh)
        logits = torch.matmul(qh.float().transpose(1, 2),
                              kh.float().permute(0, 2, 3, 1))  # (B,n,Q,HW)
        if mask is not None:
            logits = logits.masked_fill(mask.view(b, 1, 1, h * w),
                                        float("-inf"))
        attn = logits.softmax(-1).transpose(1, 2)
        return attn.reshape(b, nq, heads, h, w).to(q.dtype)


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """(N, C, h, w) -> (N, C, H, W) by `jax.image.resize`'s nearest
    sampling: output pixel i reads input floor((i + 0.5) * in / out)."""
    for dim, n in ((2, hw[0]), (3, hw[1])):
        m = x.shape[dim]
        if m != n:
            idx = ((torch.arange(n, dtype=torch.float32, device=x.device)
                    + 0.5) * m / n).floor().long()
            x = x.index_select(dim, idx)
    return x


class MaskHeadSmallConv(nn.Module):
    """The FPN-style convolution head over (B*Q, C, h, w) query maps; the
    three FPN levels it adds (strides 16, 8, 4) are the backbone's
    layer3, layer2 and layer1 outputs, shared by the Q queries of an
    image."""

    def __init__(self, dim: int, context_dim: int):
        super().__init__()
        inter = [dim, context_dim // 2, context_dim // 4, context_dim // 8,
                 context_dim // 16]
        self.lay1 = nn.Conv2d(dim, inter[0], 3, padding=1)
        self.gn1 = nn.GroupNorm(8, inter[0], eps=GN_EPS)
        self.lay2 = nn.Conv2d(inter[0], inter[1], 3, padding=1)
        self.gn2 = nn.GroupNorm(8, inter[1], eps=GN_EPS)
        fpn_dims = BACKBONE_CHANNELS[2::-1]     # 1024, 512, 256
        for i in range(3):
            setattr(self, f"adapter{i + 1}",
                    nn.Conv2d(fpn_dims[i], inter[i + 1], 1))
            setattr(self, f"lay{i + 3}",
                    nn.Conv2d(inter[i + 1], inter[i + 2], 3, padding=1))
            setattr(self, f"gn{i + 3}",
                    nn.GroupNorm(8, inter[i + 2], eps=GN_EPS))
        self.out_lay = nn.Conv2d(inter[4], 1, 3, padding=1)

    def forward(self, x: torch.Tensor,
                fpns: List[torch.Tensor]) -> torch.Tensor:
        x = F.relu(self.gn1(self.lay1(x)))
        x = F.relu(self.gn2(self.lay2(x)))
        for i, fpn in enumerate(fpns):
            adapted = getattr(self, f"adapter{i + 1}")(fpn)   # (B, c, H, W)
            b, c, hh, ww = adapted.shape
            # each image's map added to its Q queries' (b-major, as
            # jnp.repeat) without repeating it in memory first
            x = (resize_nearest(x, (hh, ww)).reshape(b, -1, c, hh, ww)
                 + adapted[:, None]).reshape(-1, c, hh, ww)
            x = F.relu(getattr(self, f"gn{i + 3}")(
                getattr(self, f"lay{i + 3}")(x)))
        return self.out_lay(x)


class _SegmHeads:
    """The mask heads and their forward, after the detector's."""

    def _segm_setup(self, hidden_dim: int, nheads: int) -> None:
        self.bbox_attention = MHAttentionMap(hidden_dim, nheads)
        self.mask_head = MaskHeadSmallConv(hidden_dim + nheads, hidden_dim)

    def segm_forward(self, out: Dict, features, memory, hs,
                     batch) -> Dict:
        """Adds `pred_masks` (B, Q, H/4, W/4) float32 to `out`. Deformable
        (`memory` a list of per-level maps): the stride-16 level, its
        input projection and `memory[-3]`; vanilla: the last level's
        projection and the one memory map."""
        feats = [f for f, _ in features]
        if isinstance(memory, (list, tuple)):
            src = self.input_proj[max(len(self.input_proj) - 3, 0)](
                feats[-2])
            fpns = [feats[-2], feats[-3], feats[-4]]
            mem = memory[-3]
        else:
            src = self.input_proj(feats[-1])
            fpns = [feats[2], feats[1], feats[0]]
            mem = memory
        mask = downsample_mask(batch.mask, src.shape[-2:])
        bbox_mask = self.bbox_attention(hs[-1], mem, mask)  # (B,Q,n,h,w)
        b, nq, heads, h, w = bbox_mask.shape
        # the head's input per query: [src, attention heads], b-major
        x = torch.cat([src[:, None].expand(b, nq, *src.shape[1:]),
                       bbox_mask.to(src.dtype)], 2)
        seg = self.mask_head(x.reshape(b * nq, -1, h, w), fpns)
        out["pred_masks"] = seg.reshape(b, nq, *seg.shape[-2:]).float()
        return out


class DETRSegm(DETR, _SegmHeads):
    """`DETR` with the mask heads (`bbox_attention`, `mask_head`)."""

    def __init__(self, num_classes: int, **kw):
        super().__init__(num_classes, **kw)
        self._segm_setup(self.hidden_dim, self.nheads)

    def forward(self, batch, targets=None, prev_features=None):
        out, targets, features, memory, hs = super().forward(
            batch, targets, prev_features)
        out = self.segm_forward(out, features, memory, hs, batch)
        return out, targets, features, memory, hs


class DeformableDETRSegm(DeformableDETR, _SegmHeads):
    """`DeformableDETR` with the mask heads (`bbox_attention`,
    `mask_head`)."""

    def __init__(self, num_classes: int, **kw):
        super().__init__(num_classes, **kw)
        self._segm_setup(self.hidden_dim, kw.get("nheads", 8))

    def forward(self, batch, targets=None, prev_features=None):
        out, targets, features, memory, hs = super().forward(
            batch, targets, prev_features)
        out = self.segm_forward(out, features, memory, hs, batch)
        return out, targets, features, memory, hs


def postprocess_segm(results: Dict, outputs: Dict, target_hw,
                     threshold: float = 0.5,
                     return_probs: bool = False) -> Dict:
    """Upsample `pred_masks` bilinearly (half-pixel, no corner alignment) to
    the padded input size `target_hw`, sigmoid, and threshold unless
    `return_probs` -> `results` with `masks` (B, Q, H, W). Each image's
    crop to its valid region and rescale happen on the host."""
    masks = F.interpolate(outputs["pred_masks"], size=tuple(target_hw),
                          mode="bilinear", align_corners=False).sigmoid()
    return {**results, "masks": masks if return_probs else masks > threshold}
