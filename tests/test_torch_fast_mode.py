"""The port's TPU-fast tracking mode (`FlagshipConfig.tpu_fast()`: windowed
encoder, exact-MSDA decoder, cached previous-frame memory) held against the
JAX package (`train.yaml` + `deformable tracking multi_frame tpu_fast`) on
the CPU at a tiny width: the config against the YAML loader, weight
conversion of every port param, the cached forward on frame 0 and on
frame 1 with `prev_features`, a 4-frame `Tracker` and a 2-sequence x
3-frame `BatchedTracker`.

Weights come from one JAX `init` through the port's `convert.py`; inputs
are drawn with numpy from a seed. Tolerances as in test_torch_model.py and
test_torch_tracker.py: float32 on both sides summed in different orders,
outputs to 1e-4; the tracker fixture's scores keep clear of the
thresholds, so ids are identical and boxes agree to 1e-3 pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import assert_config_matches
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models.postprocess import \
    postprocess_sigmoid as jax_postprocess
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.tracking import tracker as jtr
from trackformer_tpu.tracking.batched import BatchedTracker as JBatched
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.ops import msda, window_attn
from trackformer_tpu_torch.structures import FrameBatch
from trackformer_tpu_torch.tracking import BatchedTracker, Tracker
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

NAMED = ["deformable", "tracking", "multi_frame", "tpu_fast"]
# two encoder layers, so that both shift parities run
TINY = {"enc_layers": 2, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 12,
        "dataset": "mot_crowdhuman"}
H, W = 64, 96
VALID_HW = np.array([[60, 90]], np.int32)
ORIG_SIZE = np.array([[120, 180]], np.int32)
MAX_TRACKS = 8
# the flagship tracker settings (reid_sim_threshold 0: the Hungarian reid
# runs but revives nothing), with the score thresholds raised into the
# random model's score range so that tracks are born, kept and
# terminated, and NMS tightened so that it bites
TRACKER_CFG = {**FlagshipConfig().tracker_cfg, "max_tracks": MAX_TRACKS,
               "detection_obj_score_thresh": 0.8,
               "track_obj_score_thresh": 0.79,
               "track_nms_thresh": 0.7, "detection_nms_thresh": 0.7}


@pytest.fixture(scope="module")
def models():
    args = nested_namespace(load_config(
        "train.yaml", NAMED, {**TINY, "tpu.compute_dtype": "float32"}))
    jmodel = jax_build_model(args)[0]
    img = np.zeros((1, H, W, 3), np.float32)
    jb = JFrameBatch.from_images(jnp.asarray(img), jnp.asarray(VALID_HW))
    params = jax.tree.map(np.asarray,
                          jax.jit(jmodel.init)(jax.random.PRNGKey(3), jb))
    # signal through the zero-initialized offsets and box heads, and a
    # person detector: class-0 logits near 0 (score ~0.5) instead of the
    # focal prior, so that the thresholds split the queries
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * noise.randn(*x.shape).astype(x.dtype)
        if any(getattr(k, "key", "") in ("sampling_offsets",
                                          "attention_weights", "layer_2")
               for k in p) else x, params)
    for i in range(TINY["dec_layers"]):
        head = params["params"][f"class_embed_{i}"]
        head["bias"] = head["bias"].copy()
        head["bias"][0] = 0.0
    cfg = FlagshipConfig.tpu_fast(compute_dtype="float32", **TINY)
    tmodel, postprocess = build_model(cfg, "cpu")
    tmodel.load_state_dict(jax_params_to_state_dict(params))

    def japply(p, b, t, pf):
        return jmodel.apply(p, b, t, pf, deterministic=True)
    return params, jax.jit(japply), japply, tmodel, postprocess


def frames(n, seed):
    """n drifting noisy frames: (JAX batch, port batch) each."""
    rng = np.random.RandomState(seed)
    base = rng.randn(1, H, W, 3).astype(np.float32)
    out = []
    for t in range(n):
        img = np.roll(base, (2 * t, 3 * t), axis=(1, 2))
        img = img + 0.3 * rng.randn(*img.shape).astype(np.float32)
        out.append((JFrameBatch.from_images(jnp.asarray(img),
                                            jnp.asarray(VALID_HW)),
                    FrameBatch.from_images(torch.from_numpy(img),
                                           torch.from_numpy(VALID_HW))))
    return out


def test_fast_config_matches_yaml():
    assert_config_matches(FlagshipConfig.tpu_fast(),
                          load_config("train.yaml", NAMED))


@pytest.mark.parametrize("mode", [("windowed", False, 12),
                                  ("windowed", True, 4)],
                         ids=["windowed_uncached", "windowed_cached"])
def test_factory_rejects_other_encoder_modes(mode):
    """The windowed encoder, with or without the cached memory, at a
    window side no kernel takes (sides 8 and 16 are ported, and exact MSDA
    over the cached memory: `test_torch_variants.py`,
    `test_torch_variants_rest.py`, `test_torch_window16.py`)."""
    cfg = FlagshipConfig().replace(encoder_attention=mode[0],
                                   cached_prev_memory=mode[1],
                                   encoder_window=mode[2])
    with pytest.raises(NotImplementedError, match="window sides"):
        build_model(cfg, "cpu")


def test_fast_conversion_covers_every_port_param(models):
    params, _, _, tmodel, _ = models
    sd = jax_params_to_state_dict(params)
    port = tmodel.state_dict()
    assert set(sd) == set(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    # every JAX leaf lands once: q/k/v pack three leaves into one key
    n_leaves = len(jax.tree_util.tree_leaves(params))
    n_packed = sum(1 for k in sd if k.endswith(("in_proj_weight",
                                                "in_proj_bias")))
    assert n_leaves == len(sd) + 2 * n_packed
    assert "transformer.frame_embed" in sd
    assert "transformer.encoder.fuse.1.down.3.weight" in sd
    assert "transformer.encoder.layers.1.self_attn.in_proj_weight" in sd


def test_fast_forward_matches_jax(models):
    """Frame 0 encodes the current frame for both halves of the memory;
    frame 1 reuses frame 0's encoded memory (`prev_features[-1]`)."""
    params, japply, _, tmodel, _ = models
    (jb0, tb0), (jb1, tb1) = frames(2, seed=5)
    jprev = tprev = None
    msda.reset_launch_counts()
    window_attn.reset_launch_counts()
    for jb, tb in ((jb0, tb0), (jb1, tb1)):
        jout, _, jprev, _, _ = japply(params, jb, None, jprev)
        with torch.no_grad():
            tout, _, tprev, _, _ = tmodel(tb, None, tprev)
        for key in ("pred_logits", "pred_boxes", "hs_embed"):
            np.testing.assert_allclose(tout[key].numpy(),
                                       np.asarray(jout[key]), atol=1e-4,
                                       rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(tprev[-1][0].numpy(),
                                   np.asarray(jprev[-1][0]), atol=1e-4,
                                   rtol=1e-4)
    # on the CPU every kernel wrapper takes its plain version
    assert sum(msda.launch_counts().values()) == 0
    assert window_attn.launch_counts()["fused_window_layer"] == 0


def compare_results(tres, jres):
    assert set(tres) == set(jres)
    for tid in jres:
        assert set(tres[tid]) == set(jres[tid]), tid
        for f in jres[tid]:
            np.testing.assert_allclose(tres[tid][f]["bbox"],
                                       jres[tid][f]["bbox"], atol=1e-3)
            assert tres[tid][f]["obj_ind"] == jres[tid][f]["obj_ind"]


def test_fast_tracker_matches_jax(models):
    params, _, japply, tmodel, postprocess = models
    jtracker = jtr.Tracker(params, japply, jax_postprocess, TRACKER_CFG,
                           hidden_dim=96, num_object_queries=TINY[
                               "num_queries"], overflow_boxes=True)
    ttracker = Tracker(tmodel, postprocess, TRACKER_CFG, hidden_dim=96,
                       num_object_queries=TINY["num_queries"],
                       overflow_boxes=True)
    per_frame = []
    for t, (jb, tb) in enumerate(frames(4, seed=0)):
        jtracker.step({"batch": jb, "orig_size": jnp.asarray(ORIG_SIZE)})
        ttracker.step({"batch": tb, "orig_size": torch.from_numpy(ORIG_SIZE)})
        jids = np.asarray(jtracker.state.ids)[np.asarray(
            jtracker.state.active)]
        tids = ttracker.state.ids[ttracker.state.active].numpy()
        assert np.array_equal(np.sort(tids), np.sort(jids)), t
        per_frame.append(set(tids.tolist()))
    compare_results(ttracker.get_results(), jtracker.get_results())
    # the fixture exercises births, kept tracks and terminations
    assert per_frame[0]
    assert any(a & b for a, b in zip(per_frame, per_frame[1:]))
    assert any(a - b for a, b in zip(per_frame, per_frame[1:]))


def test_fast_batched_tracker_matches_jax(models):
    params, _, japply, tmodel, postprocess = models
    jseqs, tseqs = [], []
    for seed in (11, 12):
        jseq, tseq = [], []
        for jb, tb in frames(3, seed):
            jseq.append({"batch": jb, "orig_size": jnp.asarray(ORIG_SIZE)})
            tseq.append({"batch": tb,
                         "orig_size": torch.from_numpy(ORIG_SIZE)})
        jseqs.append(jseq)
        tseqs.append(tseq)
    jres = JBatched(params, japply, jax_postprocess, TRACKER_CFG,
                    hidden_dim=96, num_object_queries=TINY["num_queries"],
                    overflow_boxes=True).run(jseqs)
    tres = BatchedTracker(tmodel, postprocess, TRACKER_CFG, hidden_dim=96,
                          num_object_queries=TINY["num_queries"],
                          overflow_boxes=True).run(tseqs)
    assert len(tres) == len(jres) == 2
    for t, j in zip(tres, jres):
        compare_results(t, j)
        assert t  # every sequence holds tracks
