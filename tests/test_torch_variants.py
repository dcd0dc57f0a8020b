"""The single-frame Deformable DETR family and the other switches of
`models/deformable_detr.py` held against the JAX package on the CPU at a
tiny width: one forward per switch, from the same JAX-initialized weights
through `convert.py` (and `bridge_scan_layout` for `tpu.scan_layers`), on
the same seeded frames with track queries:

  * single frame (`deformable tracking`): the exact-MSDA encoder, the
    windowed encoder over the frame (no cached memory; `tpu_fast` on a
    single frame gives this), no box refinement (shared heads), and
    `tpu.scan_layers` with and without box refinement;
  * multi-frame: 2-D positions (`multi_frame_encoding: false`), one encoder
    over both frames' 8 levels (`multi_frame_attention_separate_encoder:
    false`), exact and windowed, and the separate windowed encoder without
    the cached memory;

then the weight maps of shared heads and of the single-frame level embed
both ways, the panoptic dataset's mask model, and every still-unported
switch (masks on the cached memory) raising `NotImplementedError` with its
ROADMAP item
(the other switches: `test_torch_variants_rest.py`,
`test_torch_two_stage.py`, `test_torch_window16.py`).

Tolerance: float32 on both sides, summed in different orders through a
ResNet-50 and a few transformer layers: outputs to 1e-4 absolute and
relative (`test_torch_model.py`). The scanned JAX decoder with box
refinement reproduces the first layer's 2-D sampling through a synthetic
box (`_DecoderScanBodyRefine`), the same formula to rounding: the same
bound holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.structures import empty_targets as jempty_targets
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import (flatten_tree,
                                           jax_params_to_state_dict,
                                           state_dict_to_jax_params)
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.structures import FrameBatch, empty_targets
from trackformer_tpu_torch.utils.checkpoint import (bridge_scan_layout,
                                                    unflatten_params)
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

TINY = {"enc_layers": 2, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 8,
        "tpu.compute_dtype": "float32"}
ATOL = 1e-4
H, W = 64, 96
VALID_HW = np.array([[60, 90]], np.int32)
K = 4  # track-query slots
SINGLE = ["deformable", "tracking"]
MULTI = ["deformable", "tracking", "multi_frame"]
WINDOWED = {"tpu.encoder_attention": "windowed"}
# (named configs, overrides): one per switch of the slice
VARIANTS = {
    "single_exact": (SINGLE, {}),
    "single_windowed": (SINGLE, WINDOWED),
    "single_tpu_fast": (SINGLE + ["tpu_fast"], {}),
    "single_no_box_refine": (SINGLE, {"with_box_refine": False}),
    "single_scan_layers": (SINGLE, {"tpu.scan_layers": True}),
    "single_scan_no_refine": (SINGLE, {"tpu.scan_layers": True,
                                       "with_box_refine": False}),
    "multi_frame_2d_positions": (MULTI, {"multi_frame_encoding": False}),
    "multi_frame_joint_encoder": (
        MULTI, {"multi_frame_attention_separate_encoder": False}),
    "multi_frame_joint_windowed": (
        MULTI, {"multi_frame_attention_separate_encoder": False,
                **WINDOWED}),
    "multi_frame_windowed_uncached": (MULTI, WINDOWED),
}


def jax_config(named, over):
    return load_config("train.yaml", named, {**TINY, **over})


def port_config(named, over) -> FlagshipConfig:
    return FlagshipConfig.from_config(jax_config(named, over))


def jax_params(jmodel, seed=0):
    """The JAX model's param tree (its structure from an abstract `init`)
    filled from a numpy seed as flax would draw it: lecun-normal kernels,
    small random biases and norm affines near 1, unit-variance embeddings
    and FrozenBN statistics near (0, 1). An eager `init` of the ResNet-50
    would take most of the test's time."""
    img = jnp.zeros((1, H, W, 3), jnp.float32)
    jb = JFrameBatch.from_images(img, jnp.asarray(VALID_HW))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed), jb)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "weight"):
            return (1.0 + 0.05 * rng.randn(*shape)).astype(np.float32)
        if name == "running_var":
            return (1.0 + 0.1 * rng.rand(*shape)).astype(np.float32)
        if name in ("bias", "running_mean"):
            return (0.02 * rng.randn(*shape)).astype(np.float32)
        return rng.randn(*shape).astype(np.float32)     # the embeddings

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(cfg: FlagshipConfig, params):
    """The port's model on the CPU with the JAX params, bridged from the
    `scan_layers` layout where the JAX model has it."""
    tmodel, _ = build_model(cfg, "cpu")
    own = flatten_tree(state_dict_to_jax_params(tmodel.state_dict()))
    flat = bridge_scan_layout(flatten_tree(params), own, verbose=False)
    tmodel.load_state_dict(jax_params_to_state_dict(unflatten_params(flat)))
    return tmodel


def make_batch(seed):
    img = np.random.RandomState(seed).randn(1, H, W, 3).astype(np.float32)
    return (JFrameBatch.from_images(jnp.asarray(img), jnp.asarray(VALID_HW)),
            FrameBatch.from_images(torch.from_numpy(img),
                                   torch.from_numpy(VALID_HW)))


def make_track_queries(c):
    rng = np.random.RandomState(7)
    hs = rng.randn(1, K, c).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (1, K, 2)),
                            rng.uniform(0.05, 0.3, (1, K, 2))],
                           -1).astype(np.float32)
    valid = np.array([[True, False, True, True]])
    jt = jempty_targets(1, 1).with_track_queries(
        jnp.asarray(hs), jnp.asarray(boxes), jnp.asarray(valid))
    tt = empty_targets(1, 1, "cpu").with_track_queries(
        torch.from_numpy(hs), torch.from_numpy(boxes),
        torch.from_numpy(valid))
    return jt, tt


def forward_matches_jax(variant):
    """The frame after a first one (its features passed as
    `prev_features`, which a single-frame model ignores) with track
    queries: logits, boxes, the last hidden state and the memory."""
    named, over = VARIANTS[variant]
    jmodel = jax_build_model(nested_namespace(jax_config(named, over)))[0]
    params = jax_params(jmodel)
    tmodel = port_model(port_config(named, over), params)

    def japply(p, b, t, pf):
        # eager: the ops' compiled kernels are shared across the variants
        return jmodel.apply(p, b, t, pf, deterministic=True)
    jb0, tb0 = make_batch(4)
    jb, tb = make_batch(3)
    jt, tt = make_track_queries(TINY["hidden_dim"])
    jprev = japply(params, jb0, None, None)[2]
    jout, _, _, jmem, _ = japply(params, jb, jt, jprev)
    with torch.no_grad():
        tprev = tmodel(tb0)[2]
        tout, _, _, tmem, _ = tmodel(tb, tt, tprev)
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


@pytest.mark.parametrize("variant", [v for v in VARIANTS
                                     if v.startswith("single")])
def test_forward_matches_jax(variant):
    """The single-frame switches (`test_torch_variants_multi.py` holds the
    multi-frame ones)."""
    forward_matches_jax(variant)


def test_shared_heads_and_level_embed_map_both_ways():
    """Without box refinement the JAX model names its one shared head
    `class_embed_0` / `bbox_embed_0` (flax names the list's first entry);
    the port holds it at index 0. A single-frame model has 4 level embeds.
    Port -> JAX -> port is exact, and the layout check refuses a state
    dict of the other head layout."""
    from trackformer_tpu_torch.convert import _check_layout
    named, over = VARIANTS["single_no_box_refine"]
    jmodel = jax_build_model(nested_namespace(jax_config(named, over)))[0]
    params = jax_params(jmodel)
    jkeys = set(flatten_tree(params))
    assert {k.split("/")[1] for k in jkeys if "_embed_" in k} == {
        "class_embed_0", "bbox_embed_0"}
    cfg = port_config(named, over)
    tmodel = port_model(cfg, params)
    sd = tmodel.state_dict()
    assert sd["transformer.level_embed"].shape == (4, TINY["hidden_dim"])
    assert sorted({k.split(".")[1] for k in sd
                   if k.startswith(("class_embed.", "bbox_embed."))}) \
        == ["0"]
    back = flatten_tree(state_dict_to_jax_params(sd, cfg))
    assert set(back) == jkeys
    for k, v in flatten_tree(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    refined = build_model(cfg.replace(with_box_refine=True), "cpu")[0]
    with pytest.raises(ValueError, match="class heads"):
        _check_layout(set(refined.state_dict()), cfg)


# every switch that is still to port, and the ROADMAP item its error names
UNPORTED = {
    "masks_cached_memory": dict(masks=True, encoder_attention="windowed",
                                cached_prev_memory=True),
    "masks_msda_cached_memory": dict(masks=True, cached_prev_memory=True),
}


def test_panoptic_builds_the_mask_model():
    """`dataset: coco_panoptic` with masks builds the 250-class mask model
    of the family (a focal head: 250 logits) and adds the panoptic
    postprocessor; without masks there is none."""
    from trackformer_tpu_torch.models.factory import postprocessors
    from trackformer_tpu_torch.models.segmentation import DeformableDETRSegm
    cfg = FlagshipConfig(compute_dtype="float32").replace(
        dataset="coco_panoptic", masks=True, hidden_dim=256, enc_layers=1,
        dec_layers=1)
    model = build_model(cfg, "cpu")[0]
    assert type(model) is DeformableDETRSegm
    assert model.class_embed[0].out_features == 250
    assert set(postprocessors(cfg)) == {"bbox", "segm", "panoptic"}
    assert "panoptic" not in postprocessors(cfg.replace(masks=False))


@pytest.mark.parametrize("switch", list(UNPORTED))
def test_unported_switches_raise(switch):
    cfg = FlagshipConfig(compute_dtype="float32").replace(**UNPORTED[switch])
    with pytest.raises(NotImplementedError,
                       match=r"not ported \(ROADMAP Queue 1, item 9\)"):
        build_model(cfg, "cpu")
