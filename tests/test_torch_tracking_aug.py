"""The port's track-query augmentation
(trackformer_tpu_torch.models.tracking.add_track_queries_to_targets) held
against the JAX package on the CPU.

No draw of a `torch.Generator` can equal `jax.random`'s, so the parity runs
pin both sides with the `forced` dict (subset size, number of false
positives, subset order, false-positive seed positions) and compare every
track-query field: masks and indices exactly, boxes and embeddings (pure
gathers) exactly too. The unforced draws are held to what their
distribution guarantees: a subset size shared over the batch and at most
the smallest number of real targets, subset members that are real previous
targets, false positives that are distinct previous outputs outside the
subset.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.models import tracking as jtracking
from trackformer_tpu.structures import Targets as JTargets
from trackformer_tpu_torch.models import tracking
from trackformer_tpu_torch.structures import Targets

torch.set_num_threads(1)

B, T, Q, C = 2, 6, 14, 8
FP_PROB = 0.4                      # false-positive capacity ceil(2.4) + 1 = 4
TQ_FIELDS = ("tq_hs_embeds", "tq_boxes", "tq_valid", "tq_fal_pos",
             "tq_match_idx")


def make_scene(seed):
    """Previous frame: 5 and 3 real targets with track ids, each matched to
    a distinct previous output. Current frame: some ids gone (their track
    queries become false positives), slots shuffled."""
    rng = np.random.RandomState(seed)

    def targets(valid, track_ids):
        return dict(labels=np.zeros((B, T), np.int32),
                    boxes=rng.uniform(0.2, 0.8, (B, T, 4))
                    .astype(np.float32),
                    valid=valid, track_ids=track_ids,
                    orig_size=np.ones((B, 2), np.int32),
                    size=np.ones((B, 2), np.int32),
                    image_id=np.zeros((B,), np.int32))

    prev_valid = np.zeros((B, T), bool)
    prev_valid[0, :5] = True
    prev_valid[1, :3] = True
    prev_ids = np.where(prev_valid, 10 + np.arange(T)[None], -1) \
        .astype(np.int32)
    cur_ids = np.full((B, T), -1, np.int32)
    cur_ids[0, :4] = [12, 99, 10, 14]     # ids 11 and 13 left, 99 is new
    cur_ids[1, :3] = [11, 10, 98]         # id 12 left
    cur_valid = cur_ids >= 0
    prev_out = {"pred_boxes": rng.uniform(0.1, 0.9, (B, Q, 4))
                .astype(np.float32),
                "hs_embed": rng.randn(B, Q, C).astype(np.float32)}
    match_q = np.stack([rng.permutation(Q)[:T] for _ in range(B)]) \
        .astype(np.int64)
    return (targets(cur_valid, cur_ids), targets(prev_valid, prev_ids),
            prev_out, match_q)


def run_both(scene, forced, add_false_pos=True):
    cur, prev, prev_out, match_q = scene
    jcfg = jtracking.TrackingConfig(false_positive_prob=FP_PROB)
    tcfg = tracking.TrackingConfig(false_positive_prob=FP_PROB)
    want = jtracking.add_track_queries_to_targets(
        jax.random.PRNGKey(0),
        JTargets(**{k: jnp.asarray(v) for k, v in cur.items()}),
        JTargets(**{k: jnp.asarray(v) for k, v in prev.items()}),
        {k: jnp.asarray(v) for k, v in prev_out.items()},
        jnp.asarray(match_q, jnp.int32), jcfg, add_false_pos=add_false_pos,
        forced=forced)
    got = tracking.add_track_queries_to_targets(
        None,
        Targets(**{k: torch.from_numpy(v) for k, v in cur.items()}),
        Targets(**{k: torch.from_numpy(v) for k, v in prev.items()}),
        {k: torch.from_numpy(v) for k, v in prev_out.items()},
        torch.from_numpy(match_q), tcfg, add_false_pos=add_false_pos,
        forced=forced)
    return got, want


def orders(seed):
    """Subset order with the real previous targets first, and the
    false-positive seed positions."""
    rng = np.random.RandomState(seed)
    order = np.stack([np.concatenate([rng.permutation(5), [5]]),
                      np.concatenate([rng.permutation(3), 3 + np.arange(3)])])
    seed_pos = np.stack([rng.permutation(T) for _ in range(B)])
    return order.astype(np.int64), seed_pos.astype(np.int64)


@pytest.mark.parametrize("num,num_fps", [(3, 2), (3, 0), (0, 0), (1, 4),
                                         (2, 3)])
def test_forced_augmentation_matches_jax(num, num_fps):
    scene = make_scene(0)
    order, seed_pos = orders(num + 7 * num_fps)
    forced = {"num": num, "num_fps": num_fps, "order": order,
              "fp_seed_pos": seed_pos}
    got, want = run_both(scene, forced)
    k = T + tracking.fp_capacity(T, FP_PROB)
    for name in TQ_FIELDS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.shape[:2] == (B, k), name
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert int(got.tq_valid.sum()) == B * (num + num_fps)
    # the targets themselves are untouched
    assert np.array_equal(got.boxes.numpy(), scene[0]["boxes"])


def test_forced_augmentation_without_false_positives_matches_jax():
    scene = make_scene(1)
    order, _ = orders(3)
    got, want = run_both(scene, {"num": 3, "order": order},
                         add_false_pos=False)
    for name in TQ_FIELDS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape[1] == T and np.array_equal(a, b), name


def test_subset_semantics():
    """Slot by slot: the subset's boxes are the matched previous outputs; a
    member whose track id is gone is a false positive, one whose id lives
    on is pinned to the current slot of that id."""
    cur, prev, prev_out, match_q = scene = make_scene(2)
    order = np.stack([np.arange(T), np.arange(T)]).astype(np.int64)
    got, _ = run_both(scene, {"num": 3, "num_fps": 0, "order": order,
                              "fp_seed_pos": order})
    for i in range(B):
        for slot in range(3):
            assert np.array_equal(got.tq_boxes[i, slot].numpy(),
                                  prev_out["pred_boxes"][i, match_q[i, slot]])
            tid = prev["track_ids"][i, slot]
            alive = np.where(cur["track_ids"][i] == tid)[0]
            assert bool(got.tq_fal_pos[i, slot]) == (len(alive) == 0)
            assert int(got.tq_match_idx[i, slot]) == (
                alive[0] if len(alive) else -1)
        assert not got.tq_valid[i, 3:].any()


@pytest.mark.parametrize("seed", range(6))
def test_unforced_draws_keep_their_invariants(seed):
    cur, prev, prev_out, match_q = make_scene(3)
    gen = torch.Generator().manual_seed(seed)
    cfg = tracking.TrackingConfig(false_positive_prob=FP_PROB)
    got = tracking.add_track_queries_to_targets(
        gen, Targets(**{k: torch.from_numpy(v) for k, v in cur.items()}),
        Targets(**{k: torch.from_numpy(v) for k, v in prev.items()}),
        {k: torch.from_numpy(v) for k, v in prev_out.items()},
        torch.from_numpy(match_q), cfg)
    valid = got.tq_valid.numpy()
    num = valid[:, :T].sum(1)
    num_fps = valid[:, T:].sum(1)
    assert num[0] == num[1] <= prev["valid"].sum(1).min()      # shared size
    assert num_fps[0] == num_fps[1] <= int(np.ceil(FP_PROB * num[0]))
    assert valid[:, :num[0]].all() and not valid[:, num[0]:T].any()
    boxes = got.tq_boxes.numpy()
    for i in range(B):
        # which previous output fills each valid slot
        src = [int(np.where((prev_out["pred_boxes"][i] == boxes[i, s])
                            .all(1))[0][0]) for s in np.where(valid[i])[0]]
        assert len(set(src)) == len(src)        # distinct, FPs unused
        real = set(match_q[i][prev["valid"][i]].tolist())
        assert set(src[:num[i]]) <= real        # members are real targets
        assert got.tq_fal_pos[i, T:][valid[i, T:]].all()
        assert (got.tq_match_idx[i, T:] == -1).all()
    # the draws come from the generator: the same seed repeats them
    again = tracking.add_track_queries_to_targets(
        torch.Generator().manual_seed(seed),
        Targets(**{k: torch.from_numpy(v) for k, v in cur.items()}),
        Targets(**{k: torch.from_numpy(v) for k, v in prev.items()}),
        {k: torch.from_numpy(v) for k, v in prev_out.items()},
        torch.from_numpy(match_q), cfg)
    for name in TQ_FIELDS:
        assert torch.equal(getattr(got, name), getattr(again, name))


def test_unforced_draws_cover_their_range():
    """Over many seeds the shared subset size takes every value of
    [0, min valid] and false positives do appear."""
    cur, prev, prev_out, match_q = make_scene(4)
    cfg = tracking.TrackingConfig(false_positive_prob=FP_PROB)
    gen = torch.Generator().manual_seed(0)
    nums, fps = set(), set()
    for _ in range(60):
        got = tracking.add_track_queries_to_targets(
            gen, Targets(**{k: torch.from_numpy(v) for k, v in cur.items()}),
            Targets(**{k: torch.from_numpy(v) for k, v in prev.items()}),
            {k: torch.from_numpy(v) for k, v in prev_out.items()},
            torch.from_numpy(match_q), cfg)
        nums.add(int(got.tq_valid[0, :T].sum()))
        fps.add(int(got.tq_valid[0, T:].sum()))
    assert nums == {0, 1, 2, 3}
    assert fps == {0, 1, 2}


def test_capacity_and_unported_variants():
    assert tracking.fp_capacity(100, 0.1) == 11 == jtracking.fp_capacity(
        100, 0.1)
    cfg = tracking.TrackingConfig()
    with pytest.raises(NotImplementedError, match="three-frame"):
        tracking.tracking_train_forward(None, None, None, None, None, None,
                                        cfg, prev_prev_batch=object())
    with pytest.raises(NotImplementedError, match="backprop_prev_frame"):
        tracking.tracking_train_forward(
            None, None, None, None, None, None,
            tracking.TrackingConfig(backprop_prev_frame=True))
