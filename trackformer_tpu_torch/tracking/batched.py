"""Batched multi-sequence tracking: B sequences in lockstep.

Counterpart of `trackformer_tpu/tracking/batched.py`. The model runs once
per step at batch B (backbone, encoder and decoder), while every sequence
keeps its own slot state, ids and results; the track logic runs per
sequence on its slice of the batched outputs (`make_tracker_step(...,
batched=True)`). Sequences are grouped by padded frame shape; a shorter
sequence keeps stepping on its last frame with its results discarded.
A mask model's per-track masks ride the same path as in the unbatched
`Tracker`. Attention maps are the unbatched `Tracker`'s only, as in the
JAX package, whose track CLI gives the lockstep tracker no map size.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..structures import FrameBatch
from .tracker import (TrackerConfig, init_state, make_tracker_step,
                      mask_hw_of)

P_MAX = 128  # public-detection slots per frame, as in `Tracker.step`


class BatchedTracker:

    def __init__(self, model: torch.nn.Module, postprocess: Callable,
                 tracker_cfg: dict, hidden_dim: int, num_object_queries: int,
                 overflow_boxes: bool = False, with_masks: bool = False):
        self.cfg = TrackerConfig.from_dict(
            {**tracker_cfg, "num_object_queries": num_object_queries,
             "overflow_boxes": overflow_boxes, "with_masks": with_masks})
        self.hidden_dim = hidden_dim
        self.device = next(model.parameters()).device
        self._step = make_tracker_step(model, postprocess, self.cfg,
                                       batched=True)

    def _assemble(self, sequences: List, spans, t: int):
        """Frame t of every sequence as one batch on the device."""
        imgs, masks, sizes, pubs, pubv = [], [], [], [], []
        for seq, (s, e) in zip(sequences, spans):
            blob = seq[min(s + t, e - 1)]
            imgs.append(blob["batch"].images)
            masks.append(blob["batch"].mask)
            sizes.append(torch.as_tensor(blob["orig_size"]).reshape(1, 2))
            dets = np.asarray(blob.get("dets", np.zeros((0, 4))),
                              np.float32).reshape(-1, 4)[:P_MAX]
            pb = np.zeros((P_MAX, 4), np.float32)
            pv = np.zeros((P_MAX,), bool)
            pb[:len(dets)] = dets
            pv[:len(dets)] = True
            pubs.append(pb)
            pubv.append(pv)
        dev = self.device
        batch = FrameBatch(images=torch.cat(imgs).to(dev),
                           mask=torch.cat(masks).to(dev))
        return (batch, torch.cat(sizes).to(dev),
                torch.as_tensor(np.stack(pubs), device=dev),
                torch.as_tensor(np.stack(pubv), device=dev))

    def run(self, sequences: List, frame_range=(0.0, 1.0),
            logger: Optional[Callable] = None) -> List[Dict]:
        """Track all sequences (they must share a padded frame shape) in
        lockstep. Each sequence is a list of blobs as `Tracker.step` takes
        them. Returns one results dict per sequence,
        {track_id: {frame: {"bbox", "score", "obj_ind"[, "mask"]}}}."""
        b = len(sequences)
        spans = [(int(len(seq) * frame_range[0]),
                  int(len(seq) * frame_range[1])) for seq in sequences]
        lengths = [e - s for s, e in spans]
        max_len = max(lengths)
        results: List[Dict] = [dict() for _ in range(b)]
        mask_hw = (mask_hw_of(sequences[0][spans[0][0]]["batch"].images
                              .shape[1:3]) if self.cfg.with_masks else None)
        states = [init_state(self.cfg.max_tracks, self.hidden_dim,
                             self.device, mask_hw) for _ in range(b)]
        keys = ("ids", "boxes", "scores", "obj_ind") + (
            ("masks",) if self.cfg.with_masks else ())
        prev_feats = None
        with torch.inference_mode():
            for t in range(max_len):
                batch, sizes, pubs, pubv = self._assemble(sequences, spans, t)
                states, frame_results, prev_feats = self._step(
                    states, batch, sizes, pubs, pubv, prev_feats)
                res = {k: torch.stack([fr[k] for fr in frame_results])
                       .cpu().numpy() for k in keys}
                for i in range(b):
                    if t >= lengths[i]:
                        continue
                    for slot in np.nonzero(res["ids"][i] >= 0)[0]:
                        entry = {"bbox": res["boxes"][i][slot],
                                 "score": float(res["scores"][i][slot]),
                                 "obj_ind": int(res["obj_ind"][i][slot])}
                        if "masks" in res:
                            entry["mask"] = res["masks"][i][slot]
                        results[i].setdefault(int(res["ids"][i][slot]),
                                              {})[t] = entry
                if logger:
                    logger(t, max_len)
        return results


def group_by_shape(sequences: List, batch_size: int) -> List[List]:
    """Group sequences into batches of equal padded frame shape."""
    by_shape: Dict = {}
    for seq in sequences:
        shape = tuple(seq[0]["batch"].images.shape)
        by_shape.setdefault(shape, []).append(seq)
    groups = []
    for seqs in by_shape.values():
        for i in range(0, len(seqs), batch_size):
            groups.append(seqs[i:i + batch_size])
    return groups
