"""How far the fast mode (the windowed encoder) lands from the exact-MSDA
model at the tracking level: both arms train from scratch with track-query
augmentation (`make_train_step(tracking=True)`, the two-frame scheme of
`models/tracking.py`) on synthetic sequences of moving rectangles with
persistent identities, then drive the port's `Tracker` over held-out
sequences, scored by the port's CLEAR-MOT / IDF1 (`utils/mot_metrics.py`
through `utils/track_utils.get_mot_accum`). Reported, merged under
"tracking" into the detection tool's result file:

  * {exact,fast}_{mota,idf1}: each arm against the true identities;
  * cross_mota / cross_idf1: the fast arm's tracks scored against the
    exact arm's tracks as pseudo ground truth.

Counterpart of the JAX package's `tools/tracking_agreement.py`: the same
scales and sequences (`make_sequence`, from the same
`numpy.random.RandomState` draws), the same single-frame model (`train.yaml`
+ `deformable tracking`, multi-frame attention off), overrides, data order
and tracker settings. Environment knobs as there: `AGREE_LR` (4e-4),
`AGREE_WARMUP` (100), `AGREE_SEED` (0). The train state is saved every
100 steps and after the last into `--ckpt-dir`, and a rerun resumes from
it.

    python -m trackformer_tpu_torch.tools.tracking_agreement 4 small \\
        --device cpu
    python -m trackformer_tpu_torch.tools.tracking_agreement 800 mid \\
        --ckpt-dir runs/track_agree
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .fast_exact_agreement import (SAVE_EVERY, card, merge_write, out_path,
                                   restore_train, save_train, take_rows)


@dataclasses.dataclass(frozen=True)
class TrackScale:
    name: str
    h: int
    w: int
    n_seq: int
    n_eval_seq: int
    t: int
    batch: int
    n_obj: int
    box_lo: int
    box_hi: int
    vmax: int
    model: Dict[str, int]
    max_obj: int


SCALES = {
    "mid": TrackScale("mid", 192, 256, 12, 6, 12, 4, 4, 24, 56, 6,
                      {"enc_layers": 4, "dec_layers": 4, "hidden_dim": 288,
                       "nheads": 8, "dim_feedforward": 1024,
                       "num_queries": 32}, 6),
    "small": TrackScale("small", 96, 128, 6, 3, 6, 4, 2, 18, 36, 4,
                        {"enc_layers": 2, "dec_layers": 2, "hidden_dim": 96,
                         "nheads": 4, "dim_feedforward": 128,
                         "num_queries": 12}, 4),
}
# the tracker settings of the JAX tool
TRACKER_CFG = {"detection_obj_score_thresh": 0.5,
               "track_obj_score_thresh": 0.5,
               "detection_nms_thresh": 0.9, "track_nms_thresh": 0.9,
               "max_tracks": 32}


def make_sequence(rng: np.random.RandomState, sc: TrackScale):
    """T frames of colored rectangles moving at constant velocity,
    bouncing off the borders -> (frames (T, H, W, 3) float32, per frame
    {track id: xyxy}): the JAX tool's draws, in its order."""
    n = rng.randint(max(1, sc.n_obj - 1), sc.n_obj + 1)
    pos = rng.uniform([0, 0], [sc.w - sc.box_hi - 1, sc.h - sc.box_hi - 1],
                      (n, 2)).astype(np.float64)
    vel = rng.uniform(-sc.vmax, sc.vmax, (n, 2))
    size = rng.randint(sc.box_lo, sc.box_hi, (n, 2)).astype(np.float64)
    color = rng.uniform(0.6, 1.6, (n, 3)).astype(np.float32)
    frames, gts = [], []
    for _ in range(sc.t):
        img = rng.normal(0.0, 0.25, (sc.h, sc.w, 3)).astype(np.float32)
        gt = {}
        for o in range(n):
            x, y = pos[o]
            bw, bh = size[o]
            xi, yi = int(round(x)), int(round(y))
            img[yi:yi + int(bh), xi:xi + int(bw)] += color[o]
            gt[o] = np.array([x, y, x + bw, y + bh], np.float32)
        frames.append(img)
        gts.append(gt)
        pos += vel
        for d, lim in ((0, sc.w), (1, sc.h)):
            over = (pos[:, d] < 0) | (pos[:, d] + size[:, d] > lim - 1)
            vel[over, d] *= -1
            pos[:, d] = np.clip(pos[:, d], 0, lim - 1 - size[:, d])
    return np.stack(frames), gts


def make_sequences(sc: TrackScale):
    """(train sequences, held-out sequences) from seed 0."""
    rng = np.random.RandomState(0)
    train = [make_sequence(rng, sc) for _ in range(sc.n_seq)]
    return train, [make_sequence(rng, sc) for _ in range(sc.n_eval_seq)]


def gts_to_targets(gts_batch, sc: TrackScale, device):
    """Per-image {tid: xyxy} -> padded `Targets` with track ids."""
    from ..structures import empty_targets
    b = len(gts_batch)
    valid = np.zeros((b, sc.max_obj), bool)
    tids = np.full((b, sc.max_obj), -1, np.int32)
    boxes = np.zeros((b, sc.max_obj, 4), np.float32)
    for i, gt in enumerate(gts_batch):
        for j, (tid, bx) in enumerate(sorted(gt.items())[:sc.max_obj]):
            valid[i, j] = True
            tids[i, j] = tid
            x0, y0, x1, y1 = bx
            boxes[i, j] = [(x0 + x1) / 2 / sc.w, (y0 + y1) / 2 / sc.h,
                           (x1 - x0) / sc.w, (y1 - y0) / sc.h]
    return empty_targets(b, sc.max_obj, device).replace(
        valid=torch.as_tensor(valid, device=device),
        boxes=torch.as_tensor(boxes, device=device),
        track_ids=torch.as_tensor(tids, device=device))


def train_config(mode: str, sc: TrackScale, steps: int) -> dict:
    """The JAX tool's config: `deformable tracking` with two-frame track
    queries and no multi-frame attention. `mode` is `exact` or `fast`, as
    in the JAX tool, or an arm of the detection tool's names
    (`fast_exact_agreement.mode_over`: `fast_w16` the windowed encoder at
    window side 16); its `f32` and `remat0` tokens change nothing here,
    where every arm runs float32 without `tpu.remat`."""
    from ..utils.config import load_config
    from .fast_exact_agreement import mode_over
    lr = float(os.environ.get("AGREE_LR", "4e-4"))
    over = {**sc.model, "dataset": "mot", "aux_loss": True, "lr": lr,
            "lr_backbone": lr, "dropout": 0.0,
            "tpu.decoder_attention": "msda", **mode_over(mode),
            "tpu.max_objects": sc.max_obj,
            "tpu.lr_warmup_steps": int(os.environ.get("AGREE_WARMUP",
                                                      "100"))}
    cfg = load_config("train.yaml", ["deformable", "tracking"], over)
    cfg["multi_frame_attention"] = False
    cfg["multi_frame_encoding"] = False
    cfg["multi_frame_attention_separate_encoder"] = False
    cfg["tpu"]["compute_dtype"] = "float32"
    cfg["tpu"]["remat"] = False
    cfg["tpu"]["scan_layers"] = sc.name == "mid"
    return cfg


def train_arm(mode: str, train_seqs, sc: TrackScale, steps: int, device,
              ckpt_dir: Optional[Path] = None, seed: int = 0, log=print):
    """Train one arm -> (model, postprocess, config, losses)."""
    from ..engine import TrainState, make_optimizer, make_train_step
    from ..models import build_model
    from ..structures import FrameBatch
    from ..utils.config import FlagshipConfig

    device = torch.device(device)
    model_cfg = FlagshipConfig.from_config(train_config(mode, sc, steps))
    gen = torch.Generator(device=device).manual_seed(seed)
    model, crit_cfg, post, tracking_cfg = build_model(
        model_cfg, device, generator=gen, train=True)
    opt = make_optimizer(model_cfg, model, lr_drop_steps=[int(steps * 0.8)])
    state = TrainState.create(model, opt)
    step = make_train_step(model, crit_cfg, opt, tracking_cfg,
                           tracking=True)

    start, losses = 0, []
    tck = None
    if ckpt_dir is not None:
        tck = Path(ckpt_dir) / (f"track_agree_{sc.name}_{steps}_{mode}"
                                + (f"_s{seed}" if seed else "")
                                + "_train.pt")
        if tck.exists():
            start, losses = restore_train(tck, state, model)
            log(f"{mode}: resuming at step {start} from {tck}")

    frames_dev = torch.as_tensor(
        np.stack([s[0] for s in train_seqs]), device=device).reshape(
            -1, sc.h, sc.w, 3)                           # (N_SEQ * T, ...)
    targets_all = gts_to_targets([gt for s in train_seqs for gt in s[1]],
                                 sc, device)
    sizes = torch.tensor([[sc.h, sc.w]] * sc.batch, device=device)
    mask = FrameBatch.from_images(frames_dev[:sc.batch], sizes).mask
    pend: List[torch.Tensor] = []

    def drain():
        losses.extend(float(v) for v in pend)
        pend.clear()

    order = np.random.RandomState(seed + 1)
    t0 = time.perf_counter()
    for it in range(steps):
        seq_i = order.randint(0, len(train_seqs), sc.batch)
        t_i = order.randint(1, sc.t, sc.batch)
        if it < start:
            continue
        cur = torch.as_tensor(seq_i * sc.t + t_i, device=device)
        prev = torch.as_tensor(seq_i * sc.t + t_i - 1, device=device)
        pack = {"batch": FrameBatch(frames_dev.index_select(0, cur), mask),
                "targets": take_rows(targets_all, cur),
                "prev_batch": FrameBatch(frames_dev.index_select(0, prev),
                                         mask),
                "prev_targets": take_rows(targets_all, prev)}
        state, metrics = step(state, pack, gen)
        pend.append(metrics["loss"])
        if it % 100 == 0:
            drain()
            log(f"{mode} step {it}/{steps} loss {losses[-1]:.3f} "
                f"{time.perf_counter() - t0:.1f} s")
        if tck is not None and ((it + 1) % SAVE_EVERY == 0
                                or it + 1 == steps):
            drain()
            save_train(tck, state, it + 1, losses)
    drain()
    if losses:
        log(f"{mode}: loss {np.mean(losses[:10]):.3f} -> "
            f"{np.mean(losses[-10:]):.3f} ({len(losses)} steps, this run "
            f"{time.perf_counter() - t0:.1f} s)")
    model.eval()
    return model, post, model_cfg, losses


def run_tracker(model, post, model_cfg, eval_seqs, sc: TrackScale, device):
    """Each held-out sequence through a fresh `Tracker` -> its results."""
    from ..structures import FrameBatch
    from ..tracking.tracker import Tracker
    device = torch.device(device)
    all_results = []
    size = torch.tensor([[sc.h, sc.w]], device=device)
    for frames, _ in eval_seqs:
        tracker = Tracker(model, post, TRACKER_CFG,
                          hidden_dim=model_cfg.hidden_dim,
                          num_object_queries=model_cfg.num_queries)
        for img in frames:
            tracker.step({"batch": FrameBatch.from_images(
                torch.as_tensor(img, device=device)[None], size),
                "orig_size": np.array([[sc.h, sc.w]])})
        all_results.append(tracker.get_results())
    return all_results


class GtSeq:
    """The minimal sequence facade `get_mot_accum` reads:
    `.data[i]["gt"]`."""

    def __init__(self, gts, name: str):
        self.data = [{"gt": g} for g in gts]
        self._name = name

    def __len__(self):
        return len(self.data)

    def __str__(self):
        return self._name


def score(results_per_seq, gts_per_seq, tag: str):
    """(MOTA, IDF1) over the sequences."""
    from ..utils.mot_metrics import summarize
    from ..utils.track_utils import get_mot_accum
    accums = [get_mot_accum(res, GtSeq(gts, f"{tag}{i}"))
              for i, (res, gts) in enumerate(zip(results_per_seq,
                                                 gts_per_seq))]
    overall = summarize(accums)["OVERALL"]
    return float(overall["mota"]), float(overall["idf1"])


def results_as_gts(results_per_seq, n_frames: int):
    """Tracker results -> per frame {tid: xyxy} (the cross-arm pseudo
    ground truth)."""
    out = []
    for res in results_per_seq:
        gts = [dict() for _ in range(n_frames)]
        for tid, track in res.items():
            for f, row in track.items():
                gts[f][tid] = np.asarray(row["bbox"][:4], np.float32)
        out.append(gts)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("steps", type=int, nargs="?", default=800)
    ap.add_argument("scale", nargs="?", default="mid",
                    choices=sorted(SCALES))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sc = SCALES[args.scale]
    seed = int(os.environ.get("AGREE_SEED", "0"))
    ckpt_dir = None
    if args.ckpt_dir:
        ckpt_dir = Path(args.ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    def log(msg):
        print(msg, flush=True)

    train_seqs, eval_seqs = make_sequences(sc)
    eval_gts = [s[1] for s in eval_seqs]
    arms = {}
    for mode in ("exact", "fast"):
        model, post, model_cfg, losses = train_arm(
            mode, train_seqs, sc, args.steps, args.device, ckpt_dir, seed,
            log)
        results = run_tracker(model, post, model_cfg, eval_seqs, sc,
                              args.device)
        mota, idf1 = score(results, eval_gts, mode)
        arms[mode] = {"results": results, "mota": mota, "idf1": idf1,
                      "final_loss": float(np.mean(losses[-10:])),
                      "first_loss": float(np.mean(losses[:10]))}
        log(f"{mode}: MOTA {mota:.3f} IDF1 {idf1:.3f}")
        del model
    cross_mota, cross_idf1 = score(
        arms["fast"]["results"],
        results_as_gts(arms["exact"]["results"], sc.t), "cross")
    tracking = {
        "task": (f"synthetic {sc.w}x{sc.h} moving-rectangle tracking, "
                 f"{sc.n_seq} train / {sc.n_eval_seq} held-out sequences of "
                 f"{sc.t} frames, {args.steps} two-frame track-query steps "
                 "each mode"),
        "package": "trackformer_tpu_torch",
        "device": card() if torch.device(args.device).type == "cuda"
        else "cpu",
        "scale": sc.name,
        "seed": seed,
        "lr_warmup_steps": int(os.environ.get("AGREE_WARMUP", "100")),
        **{f"{m}_{k}": round(arms[m][k], 4) for m in ("exact", "fast")
           for k in ("mota", "idf1")},
        "cross_mota": round(cross_mota, 4),
        "cross_idf1": round(cross_idf1, 4),
        **{f"{m}_{k}_loss": round(arms[m][f"{k}_loss"], 4)
           for m in ("exact", "fast") for k in ("final", "first")},
    }
    path = Path(args.out) if args.out else out_path(sc, seed)
    merge_write(path, "tracking", tracking)
    log(json.dumps(tracking, indent=2))
    return tracking


if __name__ == "__main__":
    main()
