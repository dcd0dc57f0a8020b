"""The port's matcher, criterion and loss primitives
(trackformer_tpu_torch.models.{matcher,criterion}, ops.{losses,box_ops,
assignment}) held against the JAX package on the CPU.

Outputs and padded targets are made with numpy from a seed, without ties,
and handed to both packages: the cost matrix before and after the
track-query constraints, the matched query of every real target (focal and
softmax cost; padded targets, invalid queries, pinned track queries,
false-positive track queries), and every loss key of `compute_losses` with
auxiliary outputs. Matches are also checked for optimality against scipy on
the ragged problem. Tolerance: float32 on both sides, 1e-5; matches are
exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from trackformer_tpu.models import criterion as jcriterion
from trackformer_tpu.models import matcher as jmatcher
from trackformer_tpu.ops import box_ops as jbox_ops
from trackformer_tpu.ops import losses as jlosses
from trackformer_tpu.structures import Targets as JTargets
from trackformer_tpu_torch.models import criterion, matcher
from trackformer_tpu_torch.ops import assignment, box_ops, losses
from trackformer_tpu_torch.structures import Targets

torch.set_num_threads(1)

TOL = 1e-5


def rand_boxes(rng, *shape):
    return np.concatenate([rng.uniform(0.3, 0.7, shape + (2,)),
                           rng.uniform(0.05, 0.2, shape + (2,))],
                          -1).astype(np.float32)


def make_case(seed, b, q_obj, t, c, n_valid, k=0, n_aux=0):
    """numpy outputs and targets. With k > 0 the first k query slots are
    track queries: per image, slot 0 pinned to target 1, slot 1 a false
    positive, slot 2 pinned to target 0 (when that target is real), the
    last slot invalid, the rest unmatched-but-valid false positives."""
    rng = np.random.RandomState(seed)
    qt = k + q_obj
    tgt = dict(labels=rng.randint(0, c - 1, (b, t)).astype(np.int32),
               boxes=rand_boxes(rng, b, t),
               valid=np.zeros((b, t), bool),
               track_ids=np.full((b, t), -1, np.int32),
               orig_size=np.ones((b, 2), np.int32),
               size=np.ones((b, 2), np.int32),
               image_id=np.zeros((b,), np.int32))
    for i, n in enumerate(n_valid):
        tgt["valid"][i, :n] = True
    q_valid = np.ones((b, qt), bool)
    if k:
        tq_valid = np.ones((b, k), bool)
        tq_valid[:, -1] = False
        fal_pos = np.ones((b, k), bool)
        match_idx = np.full((b, k), -1, np.int32)
        for i, n in enumerate(n_valid):
            if n > 1:
                fal_pos[i, 0], match_idx[i, 0] = False, 1
            if n > 0:
                fal_pos[i, 2], match_idx[i, 2] = False, 0
        fal_pos &= tq_valid
        tgt.update(tq_hs_embeds=np.zeros((b, k, 8), np.float32),
                   tq_boxes=rand_boxes(rng, b, k), tq_valid=tq_valid,
                   tq_fal_pos=fal_pos, tq_match_idx=match_idx)
        q_valid[:, :k] = tq_valid
    else:
        q_valid[:, -2:] = False     # two invalid object-query slots

    def outs():
        return {"pred_logits": rng.randn(b, qt, c).astype(np.float32),
                "pred_boxes": rand_boxes(rng, b, qt), "query_valid": q_valid}

    out = outs()
    if n_aux:
        out["aux_outputs"] = [outs() for _ in range(n_aux)]
    return out, tgt


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return jnp.asarray(tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    return torch.from_numpy(tree)


def both(out, tgt):
    return ((to_jax(out), JTargets(**to_jax(tgt))),
            (to_torch(out), Targets(**to_torch(tgt))))


def configs(focal):
    kw = dict(cost_class=2.0, cost_bbox=5.0, cost_giou=2.0, focal_loss=focal)
    return jmatcher.MatcherConfig(**kw), matcher.MatcherConfig(**kw)


CASES = {
    # name: (b, q_obj, t, c, n_valid, k)
    "full": (2, 20, 8, 6, [8, 8], 0),
    "padded": (3, 20, 8, 6, [8, 3, 0], 0),
    "track_queries": (3, 12, 6, 6, [6, 2, 0], 5),
}


@pytest.mark.parametrize("focal", [False, True], ids=["softmax", "focal"])
@pytest.mark.parametrize("case", list(CASES))
def test_cost_matrix_and_constraints_match_jax(case, focal):
    b, q_obj, t, c, n_valid, k = CASES[case]
    (jout, jtgt), (tout, ttgt) = both(*make_case(0, b, q_obj, t, c, n_valid,
                                                 k))
    jcfg, tcfg = configs(focal)
    want = jmatcher._cost_matrix(jout, jtgt, jcfg)
    got = matcher._cost_matrix(tout, ttgt, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    want_c = jmatcher._apply_constraints(want, jout["query_valid"], jtgt)
    got_c = matcher._apply_constraints(got, tout["query_valid"], ttgt)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=TOL,
                               rtol=TOL)
    # the constraints sit at the same entries
    assert np.array_equal(got_c.numpy() == matcher.BIG,
                          np.asarray(want_c) == jmatcher.BIG)
    assert np.array_equal(got_c.numpy() == -1.0, np.asarray(want_c) == -1.0)


def assert_optimal(m, cost_qt, valid, name):
    """`m` (T,) against scipy on the ragged problem: real targets only, and
    only the queries a real target may take (no BIG entry)."""
    n = int(valid.sum())
    if n == 0:
        return
    cost = cost_qt.T[:n].astype(np.float64)          # (n, Qt)
    rows, cols = linear_sum_assignment(cost)
    ours = cost[np.arange(n), m[:n]].sum()
    assert len(set(m[:n].tolist())) == n, name
    np.testing.assert_allclose(ours, cost[rows, cols].sum(), rtol=1e-5,
                               atol=1e-5, err_msg=name)


@pytest.mark.parametrize("focal", [False, True], ids=["softmax", "focal"])
@pytest.mark.parametrize("case", list(CASES))
def test_match_matches_jax_and_is_optimal(case, focal):
    b, q_obj, t, c, n_valid, k = CASES[case]
    (jout, jtgt), (tout, ttgt) = both(*make_case(1, b, q_obj, t, c, n_valid,
                                                 k))
    jcfg, tcfg = configs(focal)
    want = np.asarray(jmatcher.match(jout, jtgt, jcfg))
    got = matcher.match(tout, ttgt, tcfg)
    assert got.dtype == torch.int64 and got.shape == (b, t)
    got = got.numpy()
    valid = np.asarray(jtgt.valid)
    assert np.array_equal(got[valid], want[valid])
    cost = matcher._apply_constraints(
        matcher._cost_matrix(tout, ttgt, tcfg), tout["query_valid"],
        ttgt).numpy()
    for i in range(b):
        assert_optimal(got[i], cost[i], valid[i], f"port image {i}")
        assert_optimal(want[i], cost[i], valid[i], f"jax image {i}")
    if k:
        tq = ttgt.tq_match_idx.numpy()
        for i, n in enumerate(n_valid):
            for slot in range(k):
                if tq[i, slot] >= 0:        # pinned: target -> that slot
                    assert got[i, tq[i, slot]] == slot
            # false-positive and invalid slots take no real target
            blocked = np.where(ttgt.tq_fal_pos[i].numpy()
                               | ~ttgt.tq_valid[i].numpy())[0]
            assert not set(got[i, :n].tolist()) & set(blocked.tolist())


def test_match_at_the_training_steps_size():
    """100 target slots x 611 queries (500 object queries + 111 track-query
    slots), 24 and 17 real targets, pinned and false-positive track
    queries: the problem of one match of the flagship's train step, with
    its BIG = 1e8 entries in float32 beside costs of order 1."""
    b, q_obj, t, c, k = 2, 500, 100, 20, 111
    n_valid = [24, 17]
    out, tgt = make_case(2, b, q_obj, t, c, n_valid, k)
    # most track-query slots invalid, as after a draw of a small subset
    tgt["tq_valid"][:, 12:] = False
    tgt["tq_fal_pos"] &= tgt["tq_valid"]
    out["query_valid"][:, :k] = tgt["tq_valid"]
    (jout, jtgt), (tout, ttgt) = both(out, tgt)
    jcfg, tcfg = configs(True)
    want = np.asarray(jmatcher.match(jout, jtgt, jcfg))
    got = matcher.match(tout, ttgt, tcfg).numpy()
    valid = tgt["valid"]
    assert np.array_equal(got[valid], want[valid])
    cost = matcher._apply_constraints(
        matcher._cost_matrix(tout, ttgt, tcfg), tout["query_valid"],
        ttgt).numpy()
    for i in range(b):
        assert_optimal(got[i], cost[i], valid[i], f"port image {i}")
        assert_optimal(want[i], cost[i], valid[i], f"jax image {i}")


def test_hungarian_batched_is_hungarian_per_item():
    rng = np.random.RandomState(4)
    costs = rng.rand(5, 7, 11).astype(np.float32)
    costs[1, :, 3] = assignment.BIG
    costs[2, 4] = 0.0                      # a row of ties with itself
    got = assignment.hungarian_batched(torch.from_numpy(costs))
    assert got.shape == (5, 7) and got.dtype == torch.int64
    for i in range(5):
        one = assignment.hungarian(torch.from_numpy(costs[i]))
        assert torch.equal(got[i], one)
        rows, cols = linear_sum_assignment(costs[i].astype(np.float64))
        np.testing.assert_allclose(
            costs[i][np.arange(7), got[i].numpy()].sum(),
            costs[i][rows, cols].sum(), rtol=1e-6)
    with pytest.raises(ValueError, match="R <= C"):
        assignment.hungarian_batched(torch.zeros(1, 3, 2))


@pytest.mark.parametrize("focal", [False, True], ids=["softmax", "focal"])
@pytest.mark.parametrize("case", list(CASES))
def test_compute_losses_match_jax(case, focal):
    b, q_obj, t, c, n_valid, k = CASES[case]
    (jout, jtgt), (tout, ttgt) = both(*make_case(5, b, q_obj, t, c, n_valid,
                                                 k, n_aux=2))
    jm, tm = configs(focal)
    weights = {"loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0}
    kw = dict(num_classes=c - 1, weight_dict=weights, eos_coef=0.1,
              focal_loss=focal, tracking=True)
    want = jcriterion.compute_losses(
        jout, jtgt, jcriterion.CriterionConfig(matcher=jm, **kw))
    got = criterion.compute_losses(
        tout, ttgt, criterion.CriterionConfig(matcher=tm, **kw))
    assert set(got) == set(want)
    assert {"loss_ce", "loss_bbox", "loss_giou", "cardinality_error",
            "class_error", "loss_ce_0", "loss_giou_1",
            "cardinality_error_1"} <= set(got)
    assert "class_error_0" not in got
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   atol=TOL, rtol=TOL, err_msg=key)


def test_unported_losses_raise():
    """The mask losses (focal and DICE of the matched queries' masks,
    upsampled 5x7 -> 17x26, with track queries and aux outputs) against
    JAX; the two-stage encoder outputs, which raised before they were
    ported, now give the `_enc` losses of JAX (`test_torch_two_stage.py`
    holds them at a model's proposals)."""
    out, tgt = make_case(6, 2, 6, 3, 4, [2, 3], k=4, n_aux=1)
    rng = np.random.RandomState(6)
    out["pred_masks"] = 2 * rng.randn(2, 10, 5, 7).astype(np.float32)
    tgt["masks"] = rng.rand(2, 3, 17, 26) > 0.5
    (jout, jtgt), (tout, ttgt) = both(out, tgt)
    losses_ = ("labels", "masks", "boxes")
    for focal in (False, True):
        kw = dict(num_classes=3, losses=losses_, focal_loss=focal,
                  tracking=True)
        want = jcriterion.compute_losses(
            jout, jtgt, jcriterion.CriterionConfig(
                matcher=configs(focal)[0], **kw))
        got = criterion.compute_losses(
            tout, ttgt, criterion.CriterionConfig(
                matcher=configs(focal)[1], **kw))
        assert set(got) == set(want)
        assert {"loss_mask", "loss_dice"} <= set(got)
        assert "loss_dice_0" not in got
        for key, value in want.items():
            np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                       atol=TOL, rtol=TOL, err_msg=key)
    enc = {k: tout[k] for k in ("pred_logits", "pred_boxes")}
    jenc = {k: jout[k] for k in ("pred_logits", "pred_boxes")}
    got = criterion.compute_losses({**tout, "enc_outputs": enc}, ttgt,
                                   criterion.CriterionConfig(num_classes=3))
    want = jcriterion.compute_losses({**jout, "enc_outputs": jenc}, jtgt,
                                     jcriterion.CriterionConfig(num_classes=3))
    assert set(got) == set(want) and "loss_ce_enc" in got
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   atol=TOL, rtol=TOL, err_msg=key)


def test_loss_primitives_and_giou_match_jax():
    rng = np.random.RandomState(7)
    logits = (3 * rng.randn(2, 9, 5)).astype(np.float32)
    labels = (rng.rand(2, 9, 5) < 0.2).astype(np.float32)
    mask = rng.rand(2, 9) < 0.7
    tl, tt = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jt = jnp.asarray(logits), jnp.asarray(labels)
    np.testing.assert_allclose(
        losses.sigmoid_binary_cross_entropy(tl, tt).numpy(),
        np.asarray(jlosses.sigmoid_binary_cross_entropy(jl, jt)),
        atol=TOL, rtol=TOL)
    for qm in (None, mask):
        got = losses.sigmoid_focal_loss(
            tl, tt, torch.tensor(3.0),
            query_mask=None if qm is None else torch.from_numpy(qm))
        want = jlosses.sigmoid_focal_loss(
            jl, jt, 3.0, query_mask=None if qm is None else jnp.asarray(qm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    a = rand_boxes(rng, 2, 7)
    bxs = rand_boxes(rng, 2, 7)
    bxs[0, 0] = 0.0                        # a degenerate padded box
    ta, tb = (box_ops.box_cxcywh_to_xyxy(torch.from_numpy(x))
              for x in (a, bxs))
    ja, jb = (jbox_ops.box_cxcywh_to_xyxy(jnp.asarray(x)) for x in (a, bxs))
    np.testing.assert_allclose(
        box_ops.generalized_box_iou(ta, tb).numpy(),
        np.asarray(jbox_ops.generalized_box_iou(ja, jb)), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        box_ops.elementwise_generalized_box_iou(ta, tb).numpy(),
        np.asarray(jbox_ops.elementwise_generalized_box_iou(ja, jb)),
        atol=TOL, rtol=TOL)
