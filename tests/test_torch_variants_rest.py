"""The rest of the Deformable DETR family's switches held against the JAX
package on the CPU at a tiny width, as `test_torch_variants.py` holds the
first ones (same fixtures and tolerance): one forward per switch, from the
same JAX-initialized weights through `convert.py`, on the same seeded
frames with track queries, the second frame taking the first's features:

  * the multi-frame flagship with dense decoder cross-attention
    (`tpu.decoder_attention: dense`), merged frame features
    (`merge_frame_features`), the exact encoder over the cached previous
    memory (`tpu.cached_prev_memory` with MSDA), 3 and 5 feature levels,
    and `position_embedding: learned` (sine positions, as in JAX);
  * the single-frame model over a ResNet-101 and with DC5 (`dilation`),
    and with merged frame features (the previous frame's maps merged in).

Then the weight maps of the new keys through an `.npz` both ways, the
`Tracker` against the JAX `Tracker` over 3 frames on the single-frame
model with merged frame features and on the exact flagship over the cached
memory (the same identities every frame and the same rows, as
`test_torch_variants_multi.py` holds them), `LearnedPositionEncoding`
against the JAX module, and each combination the JAX package cannot run
refused with its reason.

Tolerance: float32 on both sides, summed in different orders through a
ResNet and a few transformer layers: outputs to 1e-4 absolute and
relative (`test_torch_model.py`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_fast_mode import (ORIG_SIZE, TRACKER_CFG, compare_results,
                                  frames)
from test_torch_variants import (ATOL, MULTI, SINGLE, TINY, jax_config,
                                 jax_params, make_batch, make_track_queries,
                                 port_config, port_model)
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models.position_encoding import \
    LearnedPositionEncoding as JLearned
from trackformer_tpu.models.postprocess import \
    postprocess_sigmoid as jax_postprocess
from trackformer_tpu.tracking import tracker as jtr
from trackformer_tpu.utils.config import nested_namespace
from trackformer_tpu_torch.models.position_encoding import \
    LearnedPositionEncoding
from trackformer_tpu_torch.models.postprocess import postprocess_sigmoid
from trackformer_tpu_torch.tracking import Tracker
from trackformer_tpu_torch.convert import (_check_layout, flatten_tree,
                                           state_dict_to_jax_params)
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.utils.checkpoint import (load_model_npz,
                                                    save_model_npz)
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

# (named configs, overrides): one per switch of the slice
VARIANTS = {
    "dense_decoder": (MULTI, {"tpu.decoder_attention": "dense"}),
    "merge_frame_features": (MULTI, {"merge_frame_features": True}),
    "msda_cached_memory": (MULTI, {"tpu.cached_prev_memory": True}),
    "dense_decoder_cached": (MULTI, {"tpu.cached_prev_memory": True,
                                     "tpu.decoder_attention": "dense"}),
    "three_levels": (MULTI, {"num_feature_levels": 3}),
    "five_levels": (MULTI, {"num_feature_levels": 5,
                            "merge_frame_features": True}),
    "learned_positions": (MULTI, {"position_embedding": "learned"}),
    "single_resnet101": (SINGLE, {"backbone": "resnet101"}),
    "single_dc5": (SINGLE, {"dilation": True}),
    "single_merge_frame_features": (SINGLE, {"merge_frame_features": True}),
}


def run_both(named, over, seed=0):
    """The JAX and the port model with the same weights -> (JAX apply,
    params, port model)."""
    jmodel = jax_build_model(nested_namespace(jax_config(named, over)))[0]
    params = jax_params(jmodel, seed)
    tmodel = port_model(port_config(named, over), params)

    def japply(p, b, t, pf):
        # eager: the ops' compiled kernels are shared across the variants
        return jmodel.apply(p, b, t, pf, deterministic=True)
    return japply, params, tmodel


def assert_outputs_match(tout, jout, tmem, jmem):
    for key in ("pred_logits", "pred_boxes", "hs_embed"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=ATOL, rtol=1e-4, err_msg=key)
    assert len(tmem) == len(jmem)
    for tm, jm in zip(tmem, jmem):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL,
                                   rtol=1e-4)
    for i, aux in enumerate(jout["aux_outputs"]):
        np.testing.assert_allclose(
            tout["aux_outputs"][i]["pred_boxes"].numpy(),
            np.asarray(aux["pred_boxes"]), atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    """The frame after a first one (its features, and on the cached memory
    its encoded memory, passed as `prev_features`) with track queries:
    logits, boxes, the last hidden state, the memory and the auxiliary
    boxes."""
    named, over = VARIANTS[variant]
    japply, params, tmodel = run_both(named, over)
    jb0, tb0 = make_batch(4)
    jb, tb = make_batch(3)
    jt, tt = make_track_queries(TINY["hidden_dim"])
    jprev = japply(params, jb0, None, None)[2]
    jout, _, jfeat, jmem, _ = japply(params, jb, jt, jprev)
    with torch.no_grad():
        tprev = tmodel(tb0)[2]
        tout, _, tfeat, tmem, _ = tmodel(tb, tt, tprev)
    assert_outputs_match(tout, jout, tmem, jmem)
    assert len(tfeat) == len(jfeat)
    # the cached memory is the last feature pair: the next frame's input
    np.testing.assert_allclose(tfeat[-1][0].numpy(), np.asarray(
        jfeat[-1][0]).reshape(tfeat[-1][0].shape) if tfeat[-1][0].dim() == 3
        else np.asarray(jfeat[-1][0]).transpose(0, 3, 1, 2), atol=ATOL,
        rtol=1e-4)
    if variant.endswith("levels"):
        levels = over["num_feature_levels"]
        assert len(tmem) == 2 * levels
        assert len(tmodel.input_proj) == levels


def test_cached_memory_encodes_one_frame():
    """On the cached memory the exact encoder runs once a frame (the
    frame's 4 levels, 6 layers would make 6 launches on the card), where
    the uncached model runs it twice: counted on the CPU by the encoder
    calls."""
    named, over = VARIANTS["msda_cached_memory"]
    cached = build_model(port_config(named, over), "cpu")[0]
    plain = build_model(port_config(named, {}), "cpu")[0]
    _, tb = make_batch(3)
    for model, want in ((cached, 1), (plain, 2)):
        calls = []
        hook = model.transformer.encoder.register_forward_hook(
            lambda m, args, out: calls.append(args[0].shape[1]))
        with torch.no_grad():
            model(tb)
        hook.remove()
        assert len(calls) == want
        # each call takes one frame's 4 levels
        assert len(set(calls)) == 1
    assert cached.cached_memory and hasattr(cached.transformer,
                                            "frame_embed")


NPZ_SWITCHES = {
    "dense_decoder": ("transformer.decoder.layers.0.cross_attn."
                      "in_proj_weight", "decoder_layers_0/cross_attn/q_proj/"
                      "kernel"),
    "five_levels": ("merge_features.3.weight", "merge_features_3/kernel"),
    "msda_cached_memory": ("transformer.frame_embed", "frame_embed"),
}


@pytest.mark.parametrize("variant", list(NPZ_SWITCHES))
def test_new_keys_round_trip_through_npz(variant, tmp_path):
    """The JAX params of each switch cover the port's state dict key for
    key (dense cross-attention packed as `nn.MultiheadAttention` packs it,
    `merge_features.{l}`, the extra input projections, `frame_embed` of
    the exact cached model); port -> `.npz` -> a fresh port model is bit
    equal; the layout check refuses the state dict under another config."""
    named, over = VARIANTS[variant]
    _, params, tmodel = run_both(named, over)
    key, jpath = NPZ_SWITCHES[variant]
    cfg = port_config(named, over)
    sd = tmodel.state_dict()
    assert key in sd
    back = flatten_tree(state_dict_to_jax_params(sd, cfg))
    jflat = flatten_tree(params)
    assert set(back) == set(jflat) and "params/" + jpath in back
    for k, v in jflat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    path = tmp_path / "m.npz"
    save_model_npz(tmodel, path, cfg)
    fresh = build_model(cfg, "cpu")[0]
    load_model_npz(fresh, path)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="does not fit"):
        _check_layout(set(sd), port_config(named, {}))


# combinations the JAX package cannot run, or a knob value neither
# package knows: the error and what its message names
REFUSED = {
    "two_levels": (dict(num_feature_levels=2), ValueError, "IndexError"),
    "one_level": (dict(num_feature_levels=1), ValueError, "IndexError"),
    "window_12": (dict(encoder_attention="windowed", encoder_window=12),
                  NotImplementedError, "window sides"),
    "encoder_attention": (dict(encoder_attention="dense"), ValueError,
                          "encoder_attention"),
    "decoder_attention": (dict(decoder_attention="windowed"), ValueError,
                          "decoder_attention"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_what_jax_cannot_run_is_refused(case):
    """Fewer than 3 feature levels raise in the JAX package (IndexError
    in `_project_frame`), so the port refuses them naming it; a window
    side kernel #8 is not instantiated at and an unknown attention knob
    are refused too."""
    change, err, match = REFUSED[case]
    cfg = FlagshipConfig(compute_dtype="float32").replace(**change)
    with pytest.raises(err, match=match):
        build_model(cfg, "cpu")
    if case == "two_levels":
        jcfg = jax_config(MULTI, {"num_feature_levels": 2})
        jmodel = jax_build_model(nested_namespace(jcfg))[0]
        with pytest.raises(IndexError):
            jax_params(jmodel)


def test_learned_positions_say_once(capsys):
    """`position_embedding: learned` builds the sine model, as the JAX
    package's models ignore the flag, and says so once a process."""
    from trackformer_tpu_torch.models import factory
    factory._SAID.discard("learned")
    cfg = port_config(*VARIANTS["learned_positions"])
    for _ in range(2):
        build_model(cfg, "cpu")
    said = capsys.readouterr().out
    assert said.count("position_embedding: learned has no effect") == 1


# the class-0 bias of each tracked variant: its scores then straddle the
# tracker's thresholds, so that tracks are born, kept and ended
TRACKED = {"single_merge_frame_features": 0.8, "msda_cached_memory": 3.5}


@pytest.mark.parametrize("variant", list(TRACKED))
def test_tracker_matches_jax(variant):
    """3 frames through both `Tracker`s: the same identities every frame,
    the same rows (boxes to 1e-3 pixels)."""
    named, over = VARIANTS[variant]
    over = {**over, "dataset": "mot_crowdhuman"}
    jmodel = jax_build_model(nested_namespace(jax_config(named, over)))[0]
    params = jax_params(jmodel, seed=3)
    for name, head in params["params"].items():
        if name.startswith("class_embed_"):
            head["bias"] = head["bias"].copy()
            head["bias"][0] = TRACKED[variant]
    cfg = port_config(named, over)
    tmodel = port_model(cfg, params)

    def japply(p, b, t, pf):
        return jmodel.apply(p, b, t, pf, deterministic=True)

    kw = dict(hidden_dim=cfg.hidden_dim, num_object_queries=cfg.num_queries,
              overflow_boxes=True)
    jtracker = jtr.Tracker(params, japply, jax_postprocess, TRACKER_CFG, **kw)
    ttracker = Tracker(tmodel, postprocess_sigmoid, TRACKER_CFG, **kw)
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
    assert any(a - b for a, b in zip(per_frame, per_frame[1:])) or \
        any(b - a for a, b in zip(per_frame, per_frame[1:]))


def test_learned_position_encoding_matches_jax():
    """The same row and column tables in, the same (B, H, W, 2F) out."""
    mask = jnp.zeros((2, 7, 11), bool)
    jmod = JLearned(num_pos_feats=16)
    params = jmod.init(jax.random.PRNGKey(0), mask)
    want = jmod.apply(params, mask)
    tmod = LearnedPositionEncoding(16)
    with torch.no_grad():
        tmod.row_embed.weight.copy_(torch.from_numpy(np.asarray(
            params["params"]["row_embed"])))
        tmod.col_embed.weight.copy_(torch.from_numpy(np.asarray(
            params["params"]["col_embed"])))
        got = tmod(torch.zeros(2, 7, 11, dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, 7, 11, 32)


@pytest.mark.parametrize("route", ["v4", "dec_skip"])
def test_routes_at_ten_levels(route, monkeypatch):
    """The multi-frame model at 5 levels a frame (10 in the decoder's
    call): the routes `PALLAS_SKIP_IMPL=v4` and `MSDA_DEC_SKIP` launch the
    walk one level at a time, so 10 levels run, and give the default
    route's outputs (1e-5); the one all-level walk (`msda_patch_v6`, no
    route) takes at most 8 levels and refuses 10 before any launch."""
    from test_torch_tracker import reroute
    from trackformer_tpu_torch.ops import msda_dense
    named, over = VARIANTS["five_levels"]
    cfg = port_config(named, over)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(0))[0]
    _, tb = make_batch(3)
    _, tt = make_track_queries(TINY["hidden_dim"])
    with torch.no_grad():
        want = model(tb, tt)[0]
        calls = []
        reroute(monkeypatch, route, calls)
        got = model(tb, tt)[0]
    assert calls
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-5, rtol=1e-5)
    # the plan that `msda_patch_v6` makes on the card before its launch
    shapes = tuple((4, 6) for _ in range(10))
    assert msda_dense.WALK_MAX_LEVELS == 8
    with pytest.raises(ValueError, match="10 levels"):
        msda_dense.levels_plan(1, 240, 2, 2, 4, shapes, 2, 0, 64)
    msda_dense.levels_plan(1, 192, 2, 2, 4, shapes[:8], 2, 0, 64)
