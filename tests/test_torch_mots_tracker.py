"""The trackers with masks held against the JAX `Tracker` on the CPU, frame
by frame, with the tiny MOTS20 recipe model of `test_torch_mots.py`
(`DETRSegm`, softmax classes) from the same weights on the same seeded
64x96 frames: after every frame the active ids, and in the results each
track's box and its mask at the mask head's resolution (16x24, overlaps
resolved there). The port's `BatchedTracker` runs two sequences (the
frames, and the frames flipped) in lockstep, each against its own JAX
`Tracker` run.

Tolerances: ids and frames equal; boxes to 1e-3 pixels; each mask equal
but for at most one pixel in 100 (the mask head's float32 output differs
from JAX's by summation order, which moves a probability near 0.5 or a
near-tie between two tracks across the line).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mots import recipe_config, recipe_params
from trackformer_tpu.models.postprocess import postprocess_softmax as jpost
from trackformer_tpu.structures import FrameBatch as JFrameBatch
from trackformer_tpu.tracking import tracker as jtr
from trackformer_tpu_torch.convert import jax_params_to_state_dict
from trackformer_tpu_torch.models import build_model
from trackformer_tpu_torch.structures import FrameBatch
from trackformer_tpu_torch.tracking import BatchedTracker, Tracker
from trackformer_tpu_torch.utils.config import FlagshipConfig

torch.set_num_threads(1)

H, W = 64, 96
VALID_HW = np.array([[60, 90]], np.int32)
ORIG = np.array([[120, 180]], np.int32)
TRACKER = {**FlagshipConfig().tracker_cfg, "max_tracks": 8,
           "detection_obj_score_thresh": 0.5, "track_obj_score_thresh": 0.55}


def sequences():
    """Two sequences of 4 frames: a drifting noisy texture, and the same
    flipped left to right."""
    rng = np.random.RandomState(0)
    base = rng.randn(1, H, W, 3).astype(np.float32)
    frames = []
    for t in range(4):
        img = np.roll(base, (2 * t, 3 * t), axis=(1, 2))
        frames.append(img + 0.3 * rng.randn(*img.shape).astype(np.float32))
    return [frames, [f[:, :, ::-1].copy() for f in frames]]


@pytest.fixture(scope="module")
def runs():
    """The JAX `Tracker` over each sequence: the active ids after every
    frame and the results."""
    jmodel, params = recipe_params()
    out = []
    for frames in sequences():
        jtracker = jtr.Tracker(
            params, lambda p, b, t, pf: jmodel.apply(p, b, t, pf,
                                                     deterministic=True),
            jpost, TRACKER, hidden_dim=128, num_object_queries=10,
            with_masks=True)
        ids = []
        for img in frames:
            jtracker.step({"batch": JFrameBatch.from_images(
                jnp.asarray(img), jnp.asarray(VALID_HW)),
                "orig_size": jnp.asarray(ORIG)})
            ids.append(sorted(np.asarray(jtracker.state.ids)[np.asarray(
                jtracker.state.active)].tolist()))
        out.append(dict(ids=ids, results=jtracker.get_results()))
    return params, out


def port_model(params):
    cfg = FlagshipConfig.from_config(recipe_config())
    model, post = build_model(cfg, "cpu")
    model.load_state_dict(jax_params_to_state_dict(params))
    return model, post


def blob(img):
    return {"batch": FrameBatch.from_images(torch.from_numpy(img),
                                            torch.from_numpy(VALID_HW)),
            "orig_size": torch.from_numpy(ORIG)}


def results_match(got, want):
    assert got.keys() == want.keys()
    n_masks = 0
    for tid in want:
        assert got[tid].keys() == want[tid].keys(), tid
        for f, entry in want[tid].items():
            np.testing.assert_allclose(got[tid][f]["bbox"], entry["bbox"],
                                       atol=1e-3)
            gm, wm = got[tid][f]["mask"], np.asarray(entry["mask"])
            assert gm.shape == wm.shape == (16, 24)
            assert (gm != wm).sum() <= gm.size // 100, (tid, f)
            n_masks += int(wm.any())
    return n_masks


def test_masked_tracker_matches_jax(runs):
    """Per frame the same active ids; the same tracks, boxes and masks;
    the fixture has births, kept tracks and terminations, and masks."""
    params, jruns = runs
    model, post = port_model(params)
    kept = ended = False
    for frames, jrun in zip(sequences(), jruns):
        tracker = Tracker(model, post, TRACKER, 128, 10, with_masks=True)
        ids = []
        for img in frames:
            tracker.step(blob(img))
            ids.append(sorted(tracker.state.ids[tracker.state.active]
                              .tolist()))
        assert ids == jrun["ids"]
        assert results_match(tracker.get_results(), jrun["results"]) > 0
        kept |= any(set(a) & set(b) for a, b in zip(ids, ids[1:]))
        ended |= any(set(a) - set(b) for a, b in zip(ids, ids[1:]))
    assert kept and ended


def test_masked_batched_tracker_matches_jax(runs):
    """Both sequences in lockstep: each sequence's results as its own JAX
    `Tracker` run's."""
    params, jruns = runs
    model, post = port_model(params)
    tracker = BatchedTracker(model, post, TRACKER, 128, 10,
                             with_masks=True)
    got = tracker.run([[blob(img) for img in frames]
                       for frames in sequences()])
    for res, jrun in zip(got, jruns):
        results_match(res, jrun["results"])
