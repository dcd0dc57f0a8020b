"""The multi-frame switches of `models/deformable_detr.py` held against the
JAX package on the CPU at a tiny width, as `test_torch_variants.py` holds
the single-frame ones (same fixtures and tolerance): 2-D positions
(`multi_frame_encoding: false`), one encoder over both frames' 8 levels
(`multi_frame_attention_separate_encoder: false`), exact and windowed, and
the separate windowed encoder without the cached memory. Then the
single-frame model (`deformable tracking`) in the port's `Tracker` against
the JAX `Tracker` over 3 frames: the same identities every frame and the
same rows. The class-0 logits' bias is set to 0 (scores near 0.5, between
the thresholds) so that tracks are born, kept and ended; the rows' boxes
agree to 1e-3 pixels (`test_torch_fast_mode.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fast_mode import (ORIG_SIZE, TRACKER_CFG, compare_results,
                                  frames)
from test_torch_variants import (VARIANTS, forward_matches_jax, jax_config,
                                 jax_params, port_config, port_model)
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models.postprocess import \
    postprocess_sigmoid as jax_postprocess
from trackformer_tpu.tracking import tracker as jtr
from trackformer_tpu.utils.config import nested_namespace
from trackformer_tpu_torch.models.postprocess import postprocess_sigmoid
from trackformer_tpu_torch.tracking import Tracker

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", [v for v in VARIANTS
                                     if v.startswith("multi")])
def test_multi_frame_forward_matches_jax(variant):
    forward_matches_jax(variant)


def test_single_frame_tracker_matches_jax():
    named, over = VARIANTS["single_exact"]
    over = {**over, "dataset": "mot_crowdhuman"}
    jmodel = jax_build_model(nested_namespace(jax_config(named, over)))[0]
    params = jax_params(jmodel, seed=3)
    for name, head in params["params"].items():
        if name.startswith("class_embed_"):
            head["bias"] = head["bias"].copy()
            head["bias"][0] = 0.0
    cfg = port_config(named, over)
    tmodel = port_model(cfg, params)
    hidden, queries = cfg.hidden_dim, cfg.num_queries

    def japply(p, b, t, pf):
        return jmodel.apply(p, b, t, pf, deterministic=True)

    jtracker = jtr.Tracker(params, japply, jax_postprocess, TRACKER_CFG,
                           hidden_dim=hidden, num_object_queries=queries,
                           overflow_boxes=True)
    ttracker = Tracker(tmodel, postprocess_sigmoid, TRACKER_CFG,
                       hidden_dim=hidden, num_object_queries=queries,
                       overflow_boxes=True)
    per_frame = []
    for t, (jb, tb) in enumerate(frames(3, seed=0)):
        jtracker.step({"batch": jb, "orig_size": jnp.asarray(ORIG_SIZE)})
        ttracker.step({"batch": tb, "orig_size": torch.from_numpy(ORIG_SIZE)})
        jids = np.asarray(jtracker.state.ids)[np.asarray(
            jtracker.state.active)]
        tids = ttracker.state.ids[ttracker.state.active].numpy()
        assert np.array_equal(np.sort(tids), np.sort(jids)), t
        per_frame.append(set(tids.tolist()))
    compare_results(ttracker.get_results(), jtracker.get_results())
    assert per_frame[0]
    assert any(a & b for a, b in zip(per_frame, per_frame[1:]))
