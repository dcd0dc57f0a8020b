"""Two-stage Deformable DETR held against the JAX package on the CPU:

  * the proposals (`gen_encoder_output_proposals`: +inf and zeroed memory
    on padded and out-of-range cells) and `proposal_pos_embed`, exactly on
    the grid and to 1e-6 on the embedding;
  * the two-stage forward with `enc_outputs`, multi-frame with box
    refinement (the proposals' own head, the last), single-frame without
    it (the shared head), and under `tpu.scan_layers` (`enc_class_embed` /
    `enc_bbox_embed`, bridged to the last head), all with track queries
    given, which a two-stage model drops as the JAX package does; tolerance
    1e-4 as in `test_torch_variants.py`;
  * the top-k selection where ties reach the top: a padded B = 2 batch
    whose padded cells (all equal after `enc_output` on zeroed memory)
    outscore every valid cell; the indices `jax.lax.top_k` picks on the
    same logits, the lower index first among ties (`torch.topk` promises
    no order);
  * the criterion's `_enc` losses on the proposals (binary targets), and
    the tracker refusing a two-stage model, as the JAX `Tracker` fails on
    it;
  * one two-stage train step (tracking, whose track queries the model
    drops) against the port's own float64 step, as
    `test_torch_variants_train.py` holds the single-frame step: every loss
    key, the total and `grad_norm` to 1e-4 relative, the gradients by
    `gradient_misses`; no NaN through the +inf proposals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (FORCED, gradient_misses, jax_args,
                                   jax_pack, make_pack, recording_optimizer,
                                   torch_pack)
from test_torch_variants import (ATOL, MULTI, SINGLE, TINY, jax_config,
                                 jax_params, make_batch, make_track_queries,
                                 port_config, port_model)
from trackformer_tpu.engine import train_step as jtrain
from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models import criterion as jcriterion
from trackformer_tpu.models import deformable_transformer as jdt
from trackformer_tpu.models import tracking as jtracking
from trackformer_tpu.utils.config import nested_namespace
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.engine import (TrainState, make_optimizer,
                                          make_train_step)
from trackformer_tpu_torch.models import build_model, criterion
from trackformer_tpu_torch.models import deformable_transformer as tdt
from trackformer_tpu_torch.models.postprocess import postprocess_sigmoid
from trackformer_tpu_torch.structures import FrameBatch
from trackformer_tpu_torch.tracking import BatchedTracker, Tracker
from trackformer_tpu_torch.utils.config import FlagshipConfig, load_config

torch.set_num_threads(1)

TWO = {"two_stage": True}
VARIANTS = {
    "multi_frame_box_refine": (MULTI, TWO),
    "single_shared_heads": (SINGLE, {**TWO, "with_box_refine": False}),
    "single_scan_layers": (SINGLE, {**TWO, "tpu.scan_layers": True}),
}


def test_proposals_match_jax():
    """B = 2 with different valid regions: the proposal grid, its +inf
    cells (padding, and boxes outside (0.01, 0.99)) and the zeroed memory
    exactly; the sine embedding of the proposals to 1e-6."""
    rng = np.random.RandomState(0)
    shapes = ((12, 16), (6, 8), (3, 4))
    s = sum(h * w for h, w in shapes)
    memory = rng.randn(2, s, 8).astype(np.float32)
    masks = []
    for h, w in shapes:
        m = np.zeros((2, h, w), bool)
        m[0, h - h // 3:] = True
        m[1, :, w - w // 4:] = True
        masks.append(m.reshape(2, -1))
    mask = np.concatenate(masks, 1)
    jmem, jprop = jdt.gen_encoder_output_proposals(
        jnp.asarray(memory), jnp.asarray(mask), shapes)
    tmem, tprop = tdt.gen_encoder_output_proposals(
        torch.from_numpy(memory), torch.from_numpy(mask), shapes)
    np.testing.assert_array_equal(tmem.numpy(), np.asarray(jmem))
    np.testing.assert_allclose(tprop.numpy(), np.asarray(jprop), rtol=1e-6,
                               atol=1e-6)
    assert np.isinf(tprop.numpy()).any() and np.isfinite(tprop.numpy()).any()
    finite = np.where(np.isfinite(np.asarray(jprop)), np.asarray(jprop), 0.0)
    got = tdt.proposal_pos_embed(torch.from_numpy(finite[:, :40]))
    want = jdt.proposal_pos_embed(jnp.asarray(finite[:, :40]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got.shape == (2, 40, 512)


def test_stable_topk_orders_ties_as_jax():
    """Rows with long runs of equal scores: the same indices, in the same
    order, as `jax.lax.top_k`."""
    rng = np.random.RandomState(1)
    scores = rng.randint(0, 4, (2, 200)).astype(np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), 50)[1])
    got = tdt.stable_topk_indices(torch.from_numpy(scores), 50).numpy()
    np.testing.assert_array_equal(got, want)


def forward_both(named, over, params_edit=None, batch=None, seed=0):
    jmodel = jax_build_model(nested_namespace(jax_config(named, over)))[0]
    params = jax_params(jmodel, seed)
    if params_edit is not None:
        params = params_edit(params)
    tmodel = port_model(port_config(named, over), params)
    jb0, tb0 = make_batch(4) if batch is None else batch
    jt, tt = make_track_queries(TINY["hidden_dim"])
    # jitted: one program compiles faster than its ops eagerly
    jout = jax.jit(lambda p, b, t: jmodel.apply(
        p, b, t, None, deterministic=True))(params, jb0, jt)[0]
    with torch.no_grad():
        tout = tmodel(tb0, tt)[0]
    return jout, tout, tmodel


def assert_two_stage_match(tout, jout):
    assert tout["pred_logits"].shape[1] == TINY["num_queries"]
    for key in ("pred_logits", "pred_boxes", "hs_embed"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   atol=ATOL, rtol=1e-4, err_msg=key)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(
            tout["enc_outputs"][key].numpy(),
            np.asarray(jout["enc_outputs"][key]), atol=ATOL, rtol=1e-4,
            err_msg="enc_outputs " + key)
    for i, aux in enumerate(jout["aux_outputs"]):
        np.testing.assert_allclose(
            tout["aux_outputs"][i]["pred_boxes"].numpy(),
            np.asarray(aux["pred_boxes"]), atol=ATOL, rtol=1e-4)


@pytest.fixture(scope="module")
def forwards():
    """Each variant's (JAX outputs, port outputs, port model), run once."""
    cache = {}

    def get(variant):
        if variant not in cache:
            cache[variant] = forward_both(*VARIANTS[variant])
        return cache[variant]
    return get


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_stage_forward_matches_jax(variant, forwards):
    jout, tout, tmodel = forwards(variant)
    assert_two_stage_match(tout, jout)
    heads = len(tmodel.class_embed)
    assert heads == (1 if variant == "single_shared_heads"
                     else TINY["dec_layers"] + 1)
    assert not hasattr(tmodel, "query_embed")
    assert not hasattr(tmodel.transformer, "reference_points")


def test_topk_ties_reach_the_top(monkeypatch):
    """A padded B = 2 batch (image 1 valid on a quarter) through the port's
    two-stage model: the proposals' class head points along the padded
    cells' one feature, so their equal logits outscore every valid cell
    and more of them tie than there are queries. The port selects the
    indices `jax.lax.top_k` selects on the same logits, in its order (the
    lower index first among ties), and seeds the decoder with those
    proposals (the JAX model itself is held at B = 1 above)."""
    from trackformer_tpu_torch.models import deformable_detr as tdd
    named, over = VARIANTS["single_shared_heads"]
    cfg = port_config(named, over)
    model = build_model(cfg, "cpu", generator=torch.Generator()
                        .manual_seed(0))[0]
    with torch.no_grad():
        tr = model.transformer
        tr.enc_output.bias.normal_(0.0, 1.0,
                                   generator=torch.Generator().manual_seed(1))
        z = tr.enc_output_norm(tr.enc_output.bias[None])[0]
        model.class_embed[0].weight[0] = 4.0 * z / z.norm()
    valid = torch.tensor([[40, 60], [24, 40]], dtype=torch.int32)
    img = torch.from_numpy(np.random.RandomState(5).randn(
        2, 64, 96, 3).astype(np.float32))
    picked = []

    def record(scores, k):
        idx = tdt.stable_topk_indices(scores, k)
        picked.append((scores.clone(), idx))
        return idx
    monkeypatch.setattr(tdd, "stable_topk_indices", record)
    with torch.no_grad():
        out = model(FrameBatch.from_images(img, valid))[0]
    (scores, idx), = picked
    ties = (scores == scores.max(1, keepdim=True).values).sum(1)
    assert (ties > cfg.num_queries).all(), ties
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores.numpy()),
                                    cfg.num_queries)[1])
    np.testing.assert_array_equal(idx.numpy(), want)
    # the selected proposals are padded cells: +inf boxes, sigmoid 1
    boxes = out["enc_outputs"]["pred_boxes"]
    sel = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    assert bool((sel == 1.0).all())
    assert all(bool(torch.isfinite(v).all()) for k, v in out.items()
               if k in ("pred_logits", "pred_boxes"))


def test_enc_losses_on_the_proposals_match_jax(forwards):
    """The criterion on a two-stage model's outputs (binary `_enc` targets
    against every proposal, +inf proposals among them): the same loss keys
    and values as JAX, all finite."""
    jout, tout, _ = forwards("multi_frame_box_refine")
    rng = np.random.RandomState(2)
    from test_torch_matcher_criterion import both
    from test_torch_matcher_criterion import configs as mconfigs
    tgt = dict(labels=rng.randint(0, 2, (1, 3)).astype(np.int32),
               boxes=np.concatenate([rng.uniform(0.3, 0.7, (1, 3, 2)),
                                     rng.uniform(0.1, 0.3, (1, 3, 2))],
                                    -1).astype(np.float32),
               valid=np.array([[True, True, False]]),
               track_ids=np.full((1, 3), -1, np.int32),
               orig_size=np.ones((1, 2), np.int32),
               size=np.ones((1, 2), np.int32),
               image_id=np.zeros((1,), np.int32))
    (_, jtgt), (_, ttgt) = both({}, tgt)
    jcfg, tcfg = mconfigs(True)
    kw = dict(num_classes=20, focal_loss=True)
    want = jcriterion.compute_losses(jout, jtgt, jcriterion.CriterionConfig(
        matcher=jcfg, **kw))
    got = criterion.compute_losses(tout, ttgt, criterion.CriterionConfig(
        matcher=tcfg, **kw))
    assert set(got) == set(want)
    assert {"loss_ce_enc", "loss_bbox_enc", "loss_giou_enc"} <= set(got)
    for key, value in want.items():
        assert np.isfinite(float(got[key])), key
        np.testing.assert_allclose(float(got[key]), float(value), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def test_tracker_refuses_two_stage():
    """The JAX `Tracker` raises on a two-stage model; the port's trackers
    refuse it at construction, naming why."""
    cfg = port_config(SINGLE, TWO)
    model = build_model(cfg, "cpu")[0]
    for cls in (Tracker, BatchedTracker):
        with pytest.raises(NotImplementedError, match="two-stage"):
            cls(model, postprocess_sigmoid, cfg.tracker_cfg,
                hidden_dim=cfg.hidden_dim,
                num_object_queries=cfg.num_queries)


STEP_TINY = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 96,
             "nheads": 4, "dim_feedforward": 64, "num_queries": 8,
             "dropout": 0.0, "two_stage": True}


@pytest.fixture(scope="module")
def setup():
    args = jax_args(SINGLE, STEP_TINY)
    jmodel, jcrit, _, jtrack = jax_build_model(args)
    packs = make_pack()
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jax_pack(packs)["batch"]))
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.02 * noise.randn(*x.shape).astype(x.dtype)
        if any(getattr(k, "key", "") in ("sampling_offsets",
                                          "attention_weights", "layer_2")
               for k in p) else x, params)
    return args, jmodel, jcrit, jtrack, params, packs


def jax_step(setup, tracking):
    args, jmodel, jcrit, jtrack, params, packs = setup
    pack = jax_pack(packs)
    if not tracking:
        pack = {"batch": pack["batch"], "targets": pack["targets"]}
    real = jtracking.add_track_queries_to_targets
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtracking, "add_track_queries_to_targets",
                   lambda *a, **kw: real(*a, **{**kw, "forced": FORCED}))
        opt = recording_optimizer(jtrain.make_optimizer(args, params))
        state = jtrain.TrainState.create(params, opt)
        step = jax.jit(jtrain.make_train_step(jmodel, jcrit, opt, jtrack,
                                              tracking=tracking))
        state, metrics = step(state, pack, jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            jax_params_to_state_dict(jax.tree.map(np.asarray,
                                                  state.opt_state[0])))


def port_step(setup, tracking, dtype):
    params, packs = setup[4], setup[5]
    cfg = FlagshipConfig.from_config(load_config(
        "train.yaml", SINGLE, {**STEP_TINY, "tpu.compute_dtype": "float32"}))
    model, crit, _, track = build_model(cfg, "cpu", train=True)
    model.load_state_dict(jax_params_to_state_dict(params))
    model.to(dtype)
    opt = make_optimizer(cfg, model, lr_drop_steps=1)
    state = TrainState.create(model, opt)
    step = make_train_step(model, crit, opt, track, tracking=tracking,
                           return_grads=True)
    pack = torch_pack(packs)
    if not tracking:
        pack = {"batch": pack["batch"], "targets": pack["targets"]}
    _, metrics = step(state, pack, None, forced=FORCED)
    return metrics


def test_two_stage_train_step_matches_jax(setup):
    """The tracking step (the previous frame's forward, the match, the
    track-query draws), whose track queries the two-stage model drops as
    JAX's does: the current frame's detection losses and the `_enc` ones."""
    tracking = True
    jmetrics, jgrads = jax_step(setup, tracking)
    metrics = port_step(setup, tracking, torch.float32)
    ref = port_step(setup, tracking, torch.float64)["_grads"]
    assert set(metrics) - {"_grads"} == set(jmetrics)
    assert "loss_ce_enc" in jmetrics
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    grads = metrics["_grads"]
    assert set(grads) == set(jgrads) == set(ref)
    assert "transformer.pos_trans.weight" in grads
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    misses = gradient_misses(grads, jgrads, ref)
    assert misses == [], misses[:5]
