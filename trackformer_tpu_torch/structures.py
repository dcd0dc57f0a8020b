"""Static-shape batch structures as padded tensors with masks.

Counterpart of `trackformer_tpu/structures.py`:

  * `FrameBatch` holds images padded to a bucketed (H, W), in the JAX
    package's NHWC layout, with a bool pad mask (True = padding);
  * `Targets` holds per-image annotations padded to `max_objects` slots,
    and the track-query fields padded to a fixed capacity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class FrameBatch:
    """images (B, H, W, 3); mask (B, H, W) bool, True on padded pixels."""
    images: torch.Tensor
    mask: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.images.shape[0]

    @classmethod
    def from_images(cls, images: torch.Tensor,
                    valid_hw: Optional[torch.Tensor] = None) -> "FrameBatch":
        """valid_hw (B, 2) gives the unpadded (h, w) of each image
        (default: fully valid)."""
        b, h, w, _ = images.shape
        if valid_hw is None:
            mask = torch.zeros(b, h, w, dtype=torch.bool,
                               device=images.device)
        else:
            valid_hw = valid_hw.to(images.device)
            ys = torch.arange(h, device=images.device)[None, :, None]
            xs = torch.arange(w, device=images.device)[None, None, :]
            mask = ((ys >= valid_hw[:, 0, None, None])
                    | (xs >= valid_hw[:, 1, None, None]))
        return cls(images=images, mask=mask)


@dataclasses.dataclass
class Targets:
    """Padded ground truth (T slots) and track-query slots (K slots):
    labels (B, T); boxes (B, T, 4) normalized cxcywh; valid (B, T);
    track_ids (B, T); orig_size, size (B, 2); image_id (B,);
    tq_hs_embeds (B, K, C); tq_boxes (B, K, 4) cxcywh; tq_valid (B, K);
    tq_fal_pos (B, K); tq_match_idx (B, K)."""
    labels: torch.Tensor
    boxes: torch.Tensor
    valid: torch.Tensor
    track_ids: torch.Tensor
    orig_size: torch.Tensor
    size: torch.Tensor
    image_id: torch.Tensor
    area: Optional[torch.Tensor] = None
    iscrowd: Optional[torch.Tensor] = None
    masks: Optional[torch.Tensor] = None

    tq_hs_embeds: Optional[torch.Tensor] = None
    tq_boxes: Optional[torch.Tensor] = None
    tq_valid: Optional[torch.Tensor] = None
    tq_fal_pos: Optional[torch.Tensor] = None
    tq_match_idx: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]

    @property
    def max_objects(self) -> int:
        return self.labels.shape[1]

    @property
    def num_track_queries(self) -> int:
        return 0 if self.tq_valid is None else self.tq_valid.shape[1]

    def replace(self, **changes) -> "Targets":
        return dataclasses.replace(self, **changes)

    def with_track_queries(self, hs_embeds, boxes, valid, fal_pos=None,
                           match_idx=None) -> "Targets":
        b, k = hs_embeds.shape[:2]
        dev = hs_embeds.device
        if fal_pos is None:
            fal_pos = torch.zeros(b, k, dtype=torch.bool, device=dev)
        if match_idx is None:
            match_idx = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        return self.replace(tq_hs_embeds=hs_embeds, tq_boxes=boxes,
                            tq_valid=valid, tq_fal_pos=fal_pos,
                            tq_match_idx=match_idx)


def empty_targets(batch_size: int, max_objects: int,
                  device: torch.device | str = torch.device("cuda"),
                  mask_hw: Optional[tuple] = None) -> Targets:
    """All-padding Targets (pure detection forward passes); with `mask_hw`
    all-zero masks of that size."""
    b, t = batch_size, max_objects
    return Targets(
        labels=torch.zeros(b, t, dtype=torch.int32, device=device),
        boxes=torch.zeros(b, t, 4, device=device),
        valid=torch.zeros(b, t, dtype=torch.bool, device=device),
        track_ids=torch.full((b, t), -1, dtype=torch.int32, device=device),
        orig_size=torch.ones(b, 2, dtype=torch.int32, device=device),
        size=torch.ones(b, 2, dtype=torch.int32, device=device),
        image_id=torch.zeros(b, dtype=torch.int32, device=device),
        area=torch.zeros(b, t, device=device),
        iscrowd=torch.zeros(b, t, dtype=torch.int32, device=device),
        masks=(None if mask_hw is None else torch.zeros(
            (b, t) + tuple(mask_hw), dtype=torch.bool, device=device)),
    )
