"""The port's tracker (trackformer_tpu_torch.tracking) held against the JAX
package on the CPU: NMS, greedy column assignment and the rectangular
Hungarian solver on fixtures without ties; `_track_logic` over scripted
model outputs (births, terminations, revivals, both NMS passes, both reid
modes, both public-detection filters); and a four-frame end-to-end run of
the port's `Tracker` against the JAX `Tracker` with the same tiny model
weights, whose per-frame track ids must be identical.

Tolerances: the track logic is exact selection on float32 inputs handed
to both sides, so states must agree exactly (boxes to 1e-6). End to end,
the models differ by float32 summation order (~1e-5 in scores), and the
fixture's scores keep clear of the thresholds, so ids are identical and
boxes agree to 1e-3 pixels.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackformer_tpu.models import build_model as jax_build_model
from trackformer_tpu.models.postprocess import \
    postprocess_sigmoid as jax_postprocess
from trackformer_tpu.ops.assignment import hungarian_rect as jax_hungarian
from trackformer_tpu.ops.nms import \
    greedy_assign_by_column as jax_greedy
from trackformer_tpu.ops.nms import nms_mask as jax_nms
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.tracking import tracker as jtr
from trackformer_tpu.utils.config import load_config, nested_namespace
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.ops.assignment import hungarian_rect
from trackformer_tpu_torch.ops.nms import greedy_assign_by_column, nms_mask
from trackformer_tpu_torch.structures import FrameBatch
from trackformer_tpu_torch.tracking import tracker as ttr
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)


def random_boxes(rng, n, size=100.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(size * 0.05, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def clustered_boxes(rng, n):
    """Boxes in tight groups, so IoUs span the NMS thresholds."""
    centres = random_boxes(rng, max(1, n // 3))
    pick = rng.randint(0, len(centres), n)
    scale = rng.choice([0.2, 3.0], n)[:, None]
    jitter = (rng.uniform(-1, 1, (n, 4)) * scale).astype(np.float32)
    return centres[pick] + jitter


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.9])
@pytest.mark.parametrize("pinned", [False, True], ids=["plain", "inf_pinned"])
def test_nms_matches_jax(thresh, pinned):
    rng = np.random.RandomState(int(thresh * 10) + 3 * pinned)
    n = 40
    boxes = clustered_boxes(rng, n)
    scores = rng.permutation(n).astype(np.float32) / n + 0.01
    if pinned:  # detection NMS pins old tracks with an infinite score
        scores[rng.rand(n) < 0.3] = np.inf
    valid = rng.rand(n) < 0.8
    want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores),
                   jnp.asarray(valid), thresh)
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), thresh)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("maximize", [True, False])
def test_greedy_assign_matches_jax(maximize):
    rng = np.random.RandomState(5)
    score = rng.rand(12, 7).astype(np.float32)
    row_valid = rng.rand(12) < 0.8
    col_valid = rng.rand(7) < 0.8
    limit = 0.5
    if maximize:
        def accept(v, i):
            return v >= limit
    else:
        def accept(v, i):
            return v < limit
    want = jax_greedy(jnp.asarray(score), jnp.asarray(row_valid),
                      jnp.asarray(col_valid), accept, maximize=maximize)
    got = greedy_assign_by_column(
        torch.from_numpy(score), torch.from_numpy(row_valid),
        torch.from_numpy(col_valid), accept, maximize=maximize)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(5, 9), (7, 7), (9, 4)])
def test_hungarian_rect_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    cost = rng.rand(*shape).astype(np.float32) * 10
    want = np.asarray(jax_hungarian(jnp.asarray(cost)))
    got = hungarian_rect(torch.from_numpy(cost)).numpy()
    assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# _track_logic on scripted model outputs
# --------------------------------------------------------------------------

S, Q, C = 8, 6, 5
HW = (100.0, 100.0)


def jax_state_to_numpy(st):
    return {f: np.asarray(getattr(st, f)) for f in
            ("boxes", "scores", "hs", "ids", "obj_ind", "active", "inactive",
             "count_inactive", "count_term", "next_id", "num_reids")}


def assert_states_equal(tst, jst):
    want = jax_state_to_numpy(jst)
    for f, w in want.items():
        g = getattr(tst, f).numpy()
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=f)
        else:
            assert np.array_equal(g.astype(w.dtype), w), f


def scripted_frames(n_frames, seed):
    """Per frame: S track-query outputs + Q detections. Track i keeps its
    identity (hs near a fixed key) and is dropped now and then; detections
    re-detect dropped tracks (reid) and add new objects."""
    rng = np.random.RandomState(seed)
    keys = rng.randn(S + Q, C).astype(np.float32)
    base = random_boxes(rng, S + Q)
    frames = []
    for t in range(n_frames):
        boxes = base + rng.uniform(-1, 1, base.shape).astype(np.float32)
        boxes[S + 1] = boxes[S] + 1.0  # a near-duplicate detection
        scores = rng.uniform(0.45, 0.95, S + Q).astype(np.float32)
        scores[rng.rand(S + Q) < 0.3] = rng.uniform(0.05, 0.3)
        labels = np.where(rng.rand(S + Q) < 0.9, 0, 1).astype(np.int32)
        hs = (keys[np.r_[np.arange(S), rng.permutation(Q) % S]]
              + 0.05 * rng.randn(S + Q, C)).astype(np.float32)
        public = np.concatenate([boxes[S:S + 3] + 2.0,
                                 np.zeros((2, 4), np.float32)])
        public_valid = np.array([1, 1, 1, 0, 0], bool)
        frames.append((boxes, scores, labels, hs, public, public_valid))
    return frames


def exact_hungarian_rect(cost):
    """JAX `hungarian_rect` on the inactive x kept submatrix of a
    BIG-padded reid cost. The JAX tracker solves the full padded (S, Q)
    problem in float32, where BIG = 1e8 leaves the real costs below the
    potentials' resolution, so its matches can be suboptimal; the port
    solves this exact submatrix (ROADMAP queue 3)."""
    cost = np.asarray(cost)
    real = cost < jtr.BIG
    rows, cols = np.nonzero(real.any(1))[0], np.nonzero(real.any(0))[0]
    out = np.full(cost.shape[0], -1, np.int32)
    sub = np.asarray(jax_hungarian(jnp.asarray(cost[np.ix_(rows, cols)])))
    out[rows[sub >= 0]] = cols[sub[sub >= 0]]
    return jnp.asarray(out)


@pytest.mark.parametrize("variant", ["default", "reid_hungarian",
                                     "reid_greedy", "center_distance",
                                     "min_iou_0_5"])
def test_track_logic_matches_jax(variant, monkeypatch):
    kw = dict(max_tracks=S, num_object_queries=Q, track_nms_thresh=0.5,
              detection_nms_thresh=0.5, inactive_patience=2)
    if variant == "reid_hungarian":
        kw.update(reid_sim_threshold=1.0)
    elif variant == "reid_greedy":
        kw.update(reid_greedy_matching=True)
    elif variant in ("center_distance", "min_iou_0_5"):
        kw.update(public_detections=variant)
    jcfg = jtr.TrackerConfig(**kw)
    tcfg = ttr.TrackerConfig(**kw)
    jst = jtr.init_state(S, C)
    tst = ttr.init_state(S, C, "cpu")
    def logic(st, *a):
        return jtr._track_logic(st, a[0], a[1], a[2], a[3], None, None,
                                a[4], a[5], a[6], jcfg)
    eager = contextlib.nullcontext
    if variant == "reid_hungarian":
        # eager, so the solver sees concrete costs it can cut down
        monkeypatch.setattr(jtr, "hungarian_rect", exact_hungarian_rect)
        eager = jax.disable_jit
    else:
        logic = jax.jit(logic)
    hw = np.array(HW, np.float32)
    saw_inactive = False
    for frame in scripted_frames(6, seed=11):
        boxes, scores, labels, hs, public, public_valid = frame
        jst = jtr._prune_inactive(jst, jcfg)
        tst = ttr._prune_inactive(tst, tcfg)
        with eager():
            jst, jres = logic(jst, *map(jnp.asarray, (
                boxes, scores, labels, hs, public, public_valid, hw)))
        tst, tres = ttr._track_logic(
            tst, *map(torch.from_numpy, (boxes, scores, labels.astype(
                np.int64), hs, public, public_valid, hw)), tcfg)
        assert_states_equal(tst, jst)
        assert np.array_equal(tres["ids"].numpy(), np.asarray(jres["ids"]))
        saw_inactive |= bool(tst.inactive.any())
    assert int(tst.next_id) > 0 and saw_inactive
    if variant != "default":
        assert int(tst.num_reids) > 0 or variant in ("center_distance",
                                                     "min_iou_0_5")


# --------------------------------------------------------------------------
# end to end: the port's Tracker against the JAX Tracker, same weights
# --------------------------------------------------------------------------

NAMED = ["deformable", "tracking", "multi_frame"]
TINY = {"enc_layers": 1, "dec_layers": 2, "hidden_dim": 96, "nheads": 4,
        "dim_feedforward": 64, "num_queries": 12,
        "dataset": "mot_crowdhuman"}
H, W = 64, 96
MAX_TRACKS = 8


@pytest.fixture(scope="module")
def jax_tracker_run():
    """The JAX tracker over four frames of the tiny model: its weights, the
    frames, the active ids after each frame, its results and reid count."""
    args = nested_namespace(load_config(
        "train.yaml", NAMED, {**TINY, "tpu.compute_dtype": "float32"}))
    jmodel = jax_build_model(args)[0]
    rng = np.random.RandomState(0)
    base = rng.randn(1, H, W, 3).astype(np.float32)
    valid_hw = np.array([[60, 90]], np.int32)
    jb0 = JFrameBatch.from_images(jnp.asarray(base), jnp.asarray(valid_hw))
    # jitted: the same bits as the eager init, in a fifth of its time
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jb0))
    # a person detector: class-0 logits near 0 (score ~0.5) instead of the
    # focal prior, so the threshold splits the queries
    noise = np.random.RandomState(1)
    for i in range(TINY["dec_layers"]):
        head = params["params"][f"class_embed_{i}"]
        head["bias"] = head["bias"].copy()
        head["bias"][0] = 0.0
        last = params["params"][f"bbox_embed_{i}"]["layer_2"]
        last["kernel"] = (0.05 * noise.randn(*last["kernel"].shape)
                          ).astype(np.float32)

    # the flagship tracker settings (reid_sim_threshold 0: the Hungarian
    # reid runs but revives nothing), with the score thresholds raised into
    # this random model's score range so tracks are born, kept and
    # terminated, and NMS tightened so it bites
    tracker_cfg = {**FlagshipConfig().tracker_cfg, "max_tracks": MAX_TRACKS,
                   "detection_obj_score_thresh": 0.8,
                   "track_obj_score_thresh": 0.85,
                   "track_nms_thresh": 0.7, "detection_nms_thresh": 0.7}
    jtracker = jtr.Tracker(
        params, lambda p, b, t, pf: jmodel.apply(p, b, t, pf,
                                                 deterministic=True),
        jax_postprocess, tracker_cfg, hidden_dim=96,
        num_object_queries=TINY["num_queries"], overflow_boxes=True)
    orig_size = np.array([[120, 180]], np.int32)
    frames, ids = [], []
    for t in range(4):
        img = np.roll(base, (2 * t, 3 * t), axis=(1, 2))
        img = img + 0.3 * rng.randn(*img.shape).astype(np.float32)
        frames.append(img)
        jtracker.step({"batch": JFrameBatch.from_images(
            jnp.asarray(img), jnp.asarray(valid_hw)),
            "orig_size": jnp.asarray(orig_size)})
        ids.append(np.asarray(jtracker.state.ids)[np.asarray(
            jtracker.state.active)])
    return dict(params=params, tracker_cfg=tracker_cfg, frames=frames,
                valid_hw=valid_hw, orig_size=orig_size, ids=ids,
                results=jtracker.get_results(), num_reids=jtracker.num_reids)


def port_tracker_matches(run, host_blobs=False):
    """The port's `Tracker` on the same weights and frames: identical ids
    after every frame, boxes to 1e-3 pixels. With `host_blobs` each blob
    holds numpy arrays, as a sequence may yield them."""
    cfg = FlagshipConfig().replace(compute_dtype="float32", **TINY)
    tmodel, postprocess = build_model(cfg, "cpu")
    tmodel.load_state_dict(jax_params_to_state_dict(run["params"]))
    ttracker = ttr.Tracker(tmodel, postprocess, run["tracker_cfg"],
                           hidden_dim=96,
                           num_object_queries=TINY["num_queries"],
                           overflow_boxes=True)
    per_frame = []
    for t, img in enumerate(run["frames"]):
        batch = FrameBatch.from_images(torch.from_numpy(img),
                                       torch.from_numpy(run["valid_hw"]))
        orig_size = torch.from_numpy(run["orig_size"])
        if host_blobs:
            batch = FrameBatch(images=batch.images.numpy(),
                               mask=batch.mask.numpy())
            orig_size = run["orig_size"]
        ttracker.step({"batch": batch, "orig_size": orig_size})
        tids = ttracker.state.ids[ttracker.state.active].numpy()
        assert np.array_equal(np.sort(tids), np.sort(run["ids"][t])), t
        per_frame.append(set(tids.tolist()))

    jres, tres = run["results"], ttracker.get_results()
    assert set(tres) == set(jres)
    for tid in jres:
        assert set(tres[tid]) == set(jres[tid]), tid
        for f in jres[tid]:
            np.testing.assert_allclose(tres[tid][f]["bbox"],
                                       jres[tid][f]["bbox"], atol=1e-3)
            assert tres[tid][f]["obj_ind"] == jres[tid][f]["obj_ind"]
    # the fixture exercises births, kept tracks and terminations
    assert per_frame[0]
    assert any(a & b for a, b in zip(per_frame, per_frame[1:]))
    assert any(a - b for a, b in zip(per_frame, per_frame[1:]))
    assert ttracker.num_reids == run["num_reids"]


def test_tracker_end_to_end_matches_jax(jax_tracker_run):
    port_tracker_matches(jax_tracker_run)


def test_tracker_step_takes_host_blobs(jax_tracker_run):
    """`Tracker.step` moves the blob's batch to the model's device itself:
    numpy arrays give the results that tensors give."""
    port_tracker_matches(jax_tracker_run, host_blobs=True)


def reroute(monkeypatch, route, calls):
    """Sends the tiny model's MSDA calls through a non-default route of the
    port (the JAX side stays on its own): the limits that keep small calls
    on the default route are lowered, and every per-level call is noted."""
    from trackformer_tpu_torch.ops import msda, msda_dense
    monkeypatch.setattr(msda, "DENSE_CELL_BUDGET", 0)
    if route == "dec_skip":
        monkeypatch.setattr(msda, "MSDA_DEC_SKIP", True)
        monkeypatch.setattr(msda, "PALLAS_DENSE_MAX_CELLS", 0)
    else:
        monkeypatch.setattr(msda, "PALLAS_SKIP_IMPL", "v4")
        monkeypatch.setattr(msda, "PALLAS_V2_MIN_QUERIES", 100)
        monkeypatch.setattr(msda, "PALLAS_V4_SORT", route == "v4")
    for name in ("dense_level_pallas_v4", "dense_level_pallas_v4p"):
        real = getattr(msda_dense, name)

        def noting(*a, _real=real, _name=name):
            calls.append((_name, a[1].shape[1]))
            return _real(*a)
        monkeypatch.setattr(msda_dense, name, noting)


@pytest.mark.parametrize("route", ["v4", "v4_unsorted", "dec_skip"])
def test_tracker_end_to_end_matches_jax_on_route(jax_tracker_run, route,
                                                 monkeypatch):
    """The same run with the port's encoder calls on route "v4" (128 tokens
    query 4 levels), or all its calls under `MSDA_DEC_SKIP` (few queries:
    the decoder's 20 on 8 levels, and at this size the encoder's too): the
    routes change which function serves a level, not the
    result."""
    calls = []
    reroute(monkeypatch, route, calls)
    port_tracker_matches(jax_tracker_run)
    frames = len(jax_tracker_run["frames"])
    if route == "dec_skip":
        # every call here has few queries: per frame 2 decoder layers x 8
        # levels (12 object + 8 track queries), and the encoder's calls too
        assert sorted(set(calls)) == [("dense_level_pallas_v4p", 20),
                                      ("dense_level_pallas_v4p", 128)]
        assert calls.count(("dense_level_pallas_v4p", 20)) == frames * 2 * 8
        assert calls.count(("dense_level_pallas_v4p", 128)) == frames * 2 * 4
    else:
        # 1 encoder layer x 2 frames x 4 levels, 128 tokens
        name = "dense_level_pallas_v4p" if route == "v4" \
            else "dense_level_pallas_v4"
        assert calls == [(name, 128)] * (frames * 2 * 4)
