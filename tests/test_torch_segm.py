"""The mask heads of both model families (`models/segmentation.py`) and the
mask losses held against the JAX package on the CPU at a tiny width
(hidden 128, 8 heads, a few layers), on the same seeded inputs:

  * `resize_nearest` (the head's upsampling) at odd ratios, against
    `jax.image.resize(..., "nearest")`;
  * `MHAttentionMap` with a padded memory and `MaskHeadSmallConv` with FPN
    levels at odd ratios;
  * (`pred_masks` of the whole models: `test_torch_segm_models.py`)
  * `postprocess_segm` (bilinear to the padded size, probabilities and
    thresholded), `dice_loss`, `masks_to_boxes` and `loss_masks` through
    `compute_losses`;
  * one detection train step of the tiny `DETRSegm` (`train.yaml` +
    `mots20`, B = 2 with masks): losses against the JAX step, gradients
    held against the port's own float64 step (`gradient_misses` of
    `test_torch_train_step.py`), but for the two that are zero by
    construction, which are held to be zero in float64.

Tolerances: float32 on both sides, 1e-4 absolute and relative for the
forwards and losses (`test_torch_model.py`); the thresholded masks of
`postprocess_segm` equal except where the probability lies within 1e-5 of
the threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import gradient_misses, recording_optimizer
from trackformer_tpu.engine import train_step as jtrain
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models import criterion as jcriterion
from trackformer_tpu.models import segmentation as jsegm
from trackformer_tpu.ops import box_ops as jbox_ops
from trackformer_tpu.ops import losses as jlosses
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.structures import Targets as JTargets
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                          make_train_step)
from trackformer_tpu_torch.models import build_model, criterion
from trackformer_tpu_torch.models import segmentation as segm
from trackformer_tpu_torch.ops import box_ops, losses
from trackformer_tpu_torch.structures import FrameBatch, Targets
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 128, "nheads": 8,
        "dim_feedforward": 64, "num_queries": 5,
        "tpu.compute_dtype": "float32", "masks": True}


def close(got, want, msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=msg,
                               **(tol or TOL))


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("src,dst", [((3, 4), (5, 7)), ((5, 7), (9, 13)),
                                     ((9, 13), (18, 26)), ((4, 6), (9, 13)),
                                     ((7, 5), (3, 2))])
def test_resize_nearest_matches_jax(src, dst):
    x = np.random.RandomState(0).randn(2, 3, *src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1),
                            (2,) + dst + (3,), method="nearest")
    got = segm.resize_nearest(t(x), dst)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).transpose(0, 3, 1, 2))


def test_attention_map_and_mask_head_match_jax():
    """`MHAttentionMap` over a memory with padded rows and columns (their
    weight exactly 0), then `MaskHeadSmallConv` on its maps with FPN levels
    at odd ratios (3x4 -> 5x7 -> 9x13 -> 18x26), B = 2, 3 queries."""
    rng = np.random.RandomState(1)
    b, q, c, n = 2, 3, 128, 8
    hs = rng.randn(b, q, c).astype(np.float32)
    mem = rng.randn(b, 3, 4, c).astype(np.float32)
    mask = np.zeros((b, 3, 4), bool)
    mask[1, 2:] = True
    mask[1, :, 3:] = True
    jmap = jsegm.MHAttentionMap(c, n)
    p = jmap.init(jax.random.PRNGKey(0), jnp.asarray(hs), jnp.asarray(mem))
    want = np.asarray(jmap.apply(p, jnp.asarray(hs), jnp.asarray(mem),
                                 jnp.asarray(mask)))
    tmap = segm.MHAttentionMap(c, n)
    sd = jax_params_to_state_dict({"params": {"bbox_attention":
                                              p["params"]}})
    tmap.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tmap(t(hs), t(mem), t(mask))
    close(got.numpy(), want, "attention map")
    assert (got[1][:, :, 2:] == 0).all() and (got[1][..., 3:] == 0).all()

    src = rng.randn(b, c, 3, 4).astype(np.float32)
    x = np.concatenate([np.repeat(src, q, 0),
                        want.reshape(b * q, n, 3, 4)], 1)
    fpns = [rng.randn(b, ch, hh, ww).astype(np.float32)
            for ch, hh, ww in ((1024, 5, 7), (512, 9, 13), (256, 18, 26))]
    jhead = jsegm.MaskHeadSmallConv(c + n, c)
    nhwc = [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in fpns]
    jx = jnp.asarray(x.transpose(0, 2, 3, 1))
    hp = jhead.init(jax.random.PRNGKey(1), jx, nhwc)
    hp = jax.tree.map(lambda v: np.asarray(v) + 0.05 * rng.randn(
        *v.shape).astype(np.float32), hp)
    want = np.asarray(jhead.apply(hp, jx, nhwc)).transpose(0, 3, 1, 2)
    thead = segm.MaskHeadSmallConv(c + n, c)
    sd = jax_params_to_state_dict({"params": {"mask_head": hp["params"]}})
    thead.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = thead(t(x), [t(f) for f in fpns])
    assert got.shape == (b * q, 1, 18, 26)
    close(got.numpy(), want, "mask head")


def test_postprocess_segm_matches_jax():
    """Bilinear upsampling at a whole (x4) and an odd ratio, edges
    included; the thresholded masks agree wherever the probability is not
    within 1e-5 of 0.5."""
    rng = np.random.RandomState(3)
    pred = 3 * rng.randn(2, 4, 7, 9).astype(np.float32)
    for hw in ((28, 36), (31, 40)):
        for probs in (True, False):
            want = np.asarray(jsegm.postprocess_segm(
                {"x": 1}, {"pred_masks": jnp.asarray(pred)}, hw,
                return_probs=probs)["masks"])
            got = segm.postprocess_segm({"x": 1}, {"pred_masks": t(pred)},
                                        hw, return_probs=probs)
            assert got["x"] == 1
            if probs:
                close(got["masks"].numpy(), want, f"{hw}", atol=1e-5,
                      rtol=1e-5)
                p = want
            else:
                assert got["masks"].dtype == torch.bool
                sure = np.abs(p - 0.5) > 1e-5
                np.testing.assert_array_equal(got["masks"].numpy()[sure],
                                              want[sure])


def test_dice_loss_and_masks_to_boxes_match_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 5, 7).astype(np.float32)
    tgt = (rng.rand(6, 5, 7) > 0.6).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    nb = np.float32(3.0)
    for v in (None, valid):
        want = jlosses.dice_loss(jnp.asarray(logits), jnp.asarray(tgt),
                                 jnp.asarray(nb),
                                 None if v is None else jnp.asarray(v))
        got = losses.dice_loss(t(logits), t(tgt), torch.tensor(nb),
                               None if v is None else t(v))
        close(got.numpy(), want, "dice")
    masks = rng.rand(5, 9, 11) > 0.8
    masks[2] = False
    masks[3] = False
    masks[3, 4, 6] = True
    want = jbox_ops.masks_to_boxes(jnp.asarray(masks))
    got = box_ops.masks_to_boxes(t(masks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[2].numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(got[3].numpy(), [6, 4, 7, 5])


def mask_case(seed, b=2, q=6, t_=4, hm=20, wm=28):
    """Outputs with masks at stride 4 and targets with masks (the last
    target slot of image 1 padding)."""
    rng = np.random.RandomState(seed)
    out = {"pred_logits": rng.randn(b, q, 3).astype(np.float32),
           "pred_boxes": np.concatenate(
               [rng.uniform(0.2, 0.8, (b, q, 2)),
                rng.uniform(0.05, 0.3, (b, q, 2))], -1).astype(np.float32),
           "query_valid": np.ones((b, q), bool),
           "pred_masks": 2 * rng.randn(b, q, hm // 4, wm // 4).astype(
               np.float32)}
    valid = np.ones((b, t_), bool)
    valid[1, -1] = False
    tgt = dict(labels=rng.randint(0, 2, (b, t_)).astype(np.int32),
               boxes=np.concatenate([rng.uniform(0.2, 0.8, (b, t_, 2)),
                                     rng.uniform(0.05, 0.3, (b, t_, 2))],
                                    -1).astype(np.float32),
               valid=valid, track_ids=np.arange(b * t_, dtype=np.int32)
               .reshape(b, t_), orig_size=np.full((b, 2), 80, np.int32),
               size=np.full((b, 2), 80, np.int32),
               image_id=np.arange(b, dtype=np.int32),
               masks=rng.rand(b, t_, hm, wm) > 0.5)
    return out, tgt


def test_loss_masks_matches_jax():
    """`compute_losses` with the `masks` loss (a softmax head, aux outputs
    without masks): every key, the mask and dice losses of the final
    output only."""
    out, tgt = mask_case(5)
    aux = {k: v for k, v in out.items() if k != "pred_masks"}
    out = {**out, "aux_outputs": [aux]}
    jcfg = jcriterion.CriterionConfig(
        num_classes=2, losses=("labels", "boxes", "cardinality", "masks"))
    tcfg = criterion.CriterionConfig(
        num_classes=2, losses=("labels", "boxes", "cardinality", "masks"))
    want = jcriterion.compute_losses(
        jax.tree.map(jnp.asarray, out),
        JTargets(**{k: jnp.asarray(v) for k, v in tgt.items()}), jcfg)
    got = criterion.compute_losses(
        {**{k: t(v) for k, v in out.items() if k != "aux_outputs"},
         "aux_outputs": [{k: t(v) for k, v in aux.items()}]},
        Targets(**{k: t(v) for k, v in tgt.items()}), tcfg)
    assert set(got) == set(want)
    assert {"loss_mask", "loss_dice"} <= set(got)
    assert "loss_mask_0" not in got
    for key, value in want.items():
        close(got[key].numpy(), value, key)


def segm_pack(seed=1, b=2, t_=3):
    """A detection pack of B = 2 64x96 frames (valid 60x90) with boxes and
    their box-shaped masks at the frame size."""
    rng = np.random.RandomState(seed)
    hh, ww = 64, 96
    img = rng.randn(b, hh, ww, 3).astype(np.float32)
    valid_hw = np.array([[60, 90]] * b, np.int32)
    centre = rng.uniform(0.3, 0.7, (b, t_, 2))
    size = rng.uniform(0.15, 0.3, (b, t_, 2))
    boxes = np.concatenate([centre, size], -1).astype(np.float32)
    valid = np.ones((b, t_), bool)
    valid[1, -1] = False
    masks = np.zeros((b, t_, hh, ww), bool)
    for i in range(b):
        for j in range(t_):
            cx, cy, w_, h_ = boxes[i, j] * [90, 60, 90, 60]
            masks[i, j, int(cy - h_ / 2):int(cy + h_ / 2),
                  int(cx - w_ / 2):int(cx + w_ / 2)] = valid[i, j]
    tgt = dict(labels=np.zeros((b, t_), np.int32), boxes=boxes, valid=valid,
               track_ids=np.arange(b * t_, dtype=np.int32).reshape(b, t_),
               orig_size=np.tile([[hh, ww]], (b, 1)).astype(np.int32),
               size=valid_hw, image_id=np.arange(b, dtype=np.int32),
               masks=masks)
    return img, valid_hw, tgt


def test_masks_train_step_matches_jax():
    """One detection step of the tiny MOTS20 recipe model (`DETRSegm`,
    softmax classes, aux loss, masks): every loss key and `grad_norm`
    against the JAX step at 1e-4 relative; gradients, name by name,
    against the port's float64 step (`gradient_misses`)."""
    named = ["mots20"]
    over = {**TINY, "dropout": 0.0, "num_queries": 6}
    args = nested_namespace(load_config("train.yaml", named, over))
    args.lr_drop_steps = 100
    jmodel, jcrit, _, jtrack = jax_build_model(args)
    img, valid_hw, tgt = segm_pack()
    jpack = {"batch": JFrameBatch.from_images(jnp.asarray(img),
                                              jnp.asarray(valid_hw)),
             "targets": JTargets(**{k: jnp.asarray(v)
                                    for k, v in tgt.items()})}
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jpack["batch"]))
    opt = recording_optimizer(jtrain.make_optimizer(args, params))
    state = jtrain.TrainState.create(params, opt)
    step = jax.jit(jtrain.make_train_step(jmodel, jcrit, opt, jtrack,
                                          tracking=False))
    state, jmetrics = step(state, jpack, jax.random.PRNGKey(0))
    jgrads = jax_params_to_state_dict(jax.tree.map(np.asarray,
                                                   state.opt_state[0]))

    cfg = FlagshipConfig.from_config(load_config("train.yaml", named, over))
    tpack = {"batch": FrameBatch.from_images(t(img), t(valid_hw)),
             "targets": Targets(**{k: t(v) for k, v in tgt.items()})}
    runs = {}
    for dtype in (torch.float32, torch.float64):
        model, crit, _, track = build_model(cfg, "cpu", train=True)
        assert crit.losses[-1] == "masks"
        assert {"loss_mask", "loss_dice", "loss_mask_0"} & set(
            crit.weight_dict) == {"loss_mask", "loss_dice", "loss_mask_0"}
        model.load_state_dict(jax_params_to_state_dict(params))
        model.to(dtype)
        optimizer = make_optimizer(cfg, model, lr_drop_steps=100)
        tstep = make_train_step(model, crit, optimizer, track,
                                tracking=False, return_grads=True)
        _, metrics = tstep(TrainState.create(model, optimizer),
                           {k: v for k, v in tpack.items()}, None)
        runs[dtype] = metrics
    got = runs[torch.float32]
    for key in ("loss", "loss_mask", "loss_dice", "loss_ce", "loss_bbox",
                "loss_giou", "loss_ce_0", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), jmetrics[key], rtol=1e-4,
                                   err_msg=key)
    assert float(got["loss_mask"]) > 0 and float(got["loss_dice"]) > 0
    ref = runs[torch.float64]["_grads"]
    assert ref["mask_head.out_lay.weight"].abs().sum() > 0
    assert ref["bbox_attention.q_linear.weight"].abs().sum() > 0
    # two gradients are zero by construction, so that their float32 values
    # are rounding noise around 0: a key bias of the attention map (the
    # softmax over the keys drops a constant), and `lay5`'s bias, whose
    # GroupNorm has one channel per group at hidden 128
    zero = ("bbox_attention.k_linear.bias", "mask_head.lay5.bias")
    scale = max(g.norm().item() for g in ref.values())
    for name in zero:
        assert ref[name].norm().item() < 1e-6 * scale, name
    misses = gradient_misses(
        got["_grads"], jgrads,
        {k: v for k, v in ref.items() if k not in zero})
    assert not misses, "\n".join(misses)
