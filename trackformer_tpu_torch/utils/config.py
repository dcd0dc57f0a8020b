"""The flagship configuration as a dataclass.

It holds the values that the JAX package's
`load_config("train.yaml", ["deformable", "tracking", "multi_frame"])`
gives, together with `cfgs/track.yaml`, so the port needs neither YAML nor
the JAX package to build its main path. `FlagshipConfig.tpu_fast()` adds
the named config `tpu_fast` (`cfgs/tpu_fast.yaml`): the windowed encoder
with the cached previous-frame memory. Tests hold every field of both
against `trackformer_tpu.utils.config.load_config`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


def _default_tracker_cfg() -> Dict[str, Any]:
    # cfgs/track.yaml `tracker_cfg`
    return {
        "public_detections": False,
        "detection_obj_score_thresh": 0.4,
        "track_obj_score_thresh": 0.4,
        "detection_nms_thresh": 0.9,
        "track_nms_thresh": 0.9,
        "steps_termination": 1,
        "prev_frame_dist": 1,
        "inactive_patience": -1,
        "reid_sim_threshold": 0.0,
        "reid_sim_only": False,
        "reid_score_thresh": 0.4,
        "reid_greedy_matching": False,
    }


@dataclasses.dataclass(frozen=True)
class FlagshipConfig:
    # --- train.yaml with the named configs deformable, tracking,
    # multi_frame (keys as in the YAML) ---
    dataset: str = "coco"
    deformable: bool = True
    backbone: str = "resnet50"
    dilation: bool = False
    position_embedding: str = "sine"
    num_feature_levels: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 1024
    hidden_dim: int = 288
    nheads: int = 8
    num_queries: int = 500
    enc_n_points: int = 4
    dec_n_points: int = 4
    with_box_refine: bool = True
    two_stage: bool = False
    masks: bool = False
    focal_loss: bool = True
    aux_loss: bool = True
    overflow_boxes: bool = True
    tracking: bool = True
    multi_frame_attention: bool = True
    multi_frame_encoding: bool = True
    multi_frame_attention_separate_encoder: bool = True
    merge_frame_features: bool = False
    # train.yaml `tpu:` architecture knobs of the exact-MSDA mode
    encoder_attention: str = "msda"
    decoder_attention: str = "msda"
    scan_layers: bool = False
    cached_prev_memory: bool = False
    # window side in tokens of the windowed encoder (the JAX factory's
    # default; cfgs/tpu_fast.yaml sets the same)
    encoder_window: int = 8
    # eval transform (train.yaml `img_transform`) and the image bucket it
    # pads to (train.yaml `tpu.image_buckets`)
    val_width: int = 800
    max_size: int = 1333
    image_bucket: Tuple[int, int] = (800, 1344)
    # --- track.yaml ---
    tracker_cfg: Dict[str, Any] = dataclasses.field(
        default_factory=_default_tracker_cfg)
    max_tracks: int = 150
    compute_dtype: str = "bfloat16"

    def replace(self, **changes) -> "FlagshipConfig":
        return dataclasses.replace(self, **changes)

    @classmethod
    def tpu_fast(cls, **changes) -> "FlagshipConfig":
        """The flagship with the named config `tpu_fast` on top: windowed
        encoder, exact-MSDA decoder, cached previous-frame memory. Its
        `lr_warmup_steps` applies to training only and is not held here."""
        return cls(encoder_attention="windowed", encoder_window=8,
                   decoder_attention="msda", cached_prev_memory=True,
                   **changes)
