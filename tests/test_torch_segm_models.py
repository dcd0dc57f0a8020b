"""`pred_masks` of the whole mask models held against the JAX package on
the CPU at a tiny width (1 + 2 layers, hidden 128, 8 heads, 5 queries),
from the same JAX weights (through `convert.py`) on the same seeded
72x104 frame, whose levels (18x26, 9x13, 5x7, 3x4) are not whole
multiples of each other, with 3 track-query slots (one invalid):
`DETRSegm` (`train.yaml` + `mots20`), and `DeformableDETRSegm`
single-frame and multi-frame (whose `memory[-3]` is the previous frame's
stride-16 level); with the logits, the boxes and `postprocess_segm`'s
probabilities at the padded size.

Tolerance: float32 on both sides, 1e-4 absolute and relative
(`test_torch_model.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_segm import TINY, close, t
from test_torch_variants import jax_params
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models import segmentation as jsegm
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.structures import empty_targets as jempty_targets
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.models import segmentation as segm
from trackformer_tpu_torch.structures import FrameBatch, empty_targets
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

H, W = 72, 104                      # levels 18x26, 9x13, 5x7, 3x4
VALID_HW = np.array([[66, 100]], np.int32)
K = 3                               # track-query slots
# (named configs, overrides); the multi-frame model with 2-D positions:
# the mask head's GroupNorms want hidden / 16 divisible by 8, the 3-D
# positions hidden divisible by 3
MODELS = {
    "detr_segm": (["mots20"], {}),
    "deformable_single": (["deformable", "tracking"], {}),
    "deformable_multi": (["deformable", "tracking", "multi_frame"],
                         {"multi_frame_encoding": False}),
}


def jax_config(named, **over):
    return load_config("train.yaml", named, {**TINY, **over})


def make_frame(seed):
    img = np.random.RandomState(seed).randn(1, H, W, 3).astype(np.float32)
    return (JFrameBatch.from_images(jnp.asarray(img), jnp.asarray(VALID_HW)),
            FrameBatch.from_images(t(img), t(VALID_HW)))


def track_queries(c):
    rng = np.random.RandomState(7)
    hs = rng.randn(1, K, c).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (1, K, 2)),
                            rng.uniform(0.05, 0.3, (1, K, 2))],
                           -1).astype(np.float32)
    valid = np.array([[True, False, True]])
    return (jempty_targets(1, 1).with_track_queries(
        jnp.asarray(hs), jnp.asarray(boxes), jnp.asarray(valid)),
        empty_targets(1, 1, "cpu").with_track_queries(t(hs), t(boxes),
                                                      t(valid)))


@pytest.mark.parametrize("model", list(MODELS))
def test_pred_masks_match_jax(model):
    """A frame with track queries (for the multi-frame model the frame
    after a first one): `pred_masks` at stride 4 of the padded frame,
    logits, boxes, and `postprocess_segm` of both at the padded size."""
    named, over = MODELS[model]
    jmodel = jax_build_model(nested_namespace(jax_config(named, **over)))[0]
    params = jax_params(jmodel, seed=2)
    cfg = FlagshipConfig.from_config(jax_config(named, **over))
    tmodel, _ = build_model(cfg, "cpu")
    tmodel.load_state_dict(jax_params_to_state_dict(params))
    jb, tb = make_frame(5)
    jt, tt = track_queries(TINY["hidden_dim"])
    jprev = tprev = None
    if cfg.multi_frame_attention:
        jb0, tb0 = make_frame(4)
        jprev = jmodel.apply(params, jb0)[2]
        with torch.no_grad():
            tprev = tmodel(tb0)[2]
    jout = jmodel.apply(params, jb, jt, jprev)[0]
    with torch.no_grad():
        tout = tmodel(tb, tt, tprev)[0]
    assert tout["pred_masks"].shape == (1, K + TINY["num_queries"], 18, 26)
    for key in ("pred_masks", "pred_logits", "pred_boxes"):
        close(tout[key].numpy(), jout[key], key)
    jres = jsegm.postprocess_segm({}, jout, (H, W), return_probs=True)
    tres = segm.postprocess_segm({}, tout, (H, W), return_probs=True)
    close(tres["masks"].numpy(), jres["masks"], "probabilities")
