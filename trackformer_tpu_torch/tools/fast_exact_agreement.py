"""How far the fast mode (the windowed encoder) lands from the exact-MSDA
model, by function: train both from scratch on the same synthetic
detection task with the same budget, then report

  * exact_map / fast_map: COCO AP@[.5:.95] (and AP50) of each mode on the
    held-out scenes;
  * cross_agreement_map: AP of the fast model's detections scored against
    the exact model's detections as pseudo ground truth.

Counterpart of the JAX package's `tools/fast_exact_agreement.py`, on the
port: the same scales, the same scenes from the same
`numpy.random.RandomState` draws, the same config overrides and data
order, trained by the port's `make_train_step(tracking=False)` and scored
by the port's `datasets/coco_eval.py`. Mode names: `exact`, `fast`, and
ablation tokens after an underscore: `f32` (float32 compute) and `remat0`
(`tpu.remat` off: at the `flagship` scale the arms recompute their exact
encoder's and scanned decoder's layers in the backward, as in JAX, which
changes no number); `wN` sets the window side, 8 or 16
(kernel #8 at windows of 64 or 256 tokens). Environment knobs as in JAX:
`AGREE_LR` (default 4e-4),
`AGREE_WARMUP` (default 0), `AGREE_SEED` (default 0; the scenes stay seed
0, so every seed trains and scores on the same data), `AGREE_MAX_STEPS`
(train only the first steps of the schedule), `AGREE_MODES` (only these
arms), `AGREE_ABLATIONS` (extra arms).

The train state is saved every 100 steps and after the last into
`--ckpt-dir`, and a run started again with the same arguments resumes from
there (the data order replayed); each finished arm keeps its predictions
there too. The result
goes to `AGREEMENT_torch.json` (`AGREEMENT_torch_s{seed}.json` for a seed
other than 0) at the repository root, with the card's name and power
limit; the `small` scale writes under the temporary directory instead.
It never writes the JAX package's `AGREEMENT.json`.

    python -m trackformer_tpu_torch.tools.fast_exact_agreement 20 small \\
        --device cpu --ckpt-dir /tmp/agree
    AGREE_WARMUP=150 python -m trackformer_tpu_torch.tools.\\
fast_exact_agreement 2000 flagship --ckpt-dir runs/agree
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent.parent
SAVE_EVERY = 100


@dataclasses.dataclass(frozen=True)
class Scale:
    """A regime of the task: image size, scene counts, batch, box sizes and
    the model's size."""
    name: str
    h: int
    w: int
    n_train: int
    n_eval: int
    batch: int
    n_max: int
    box_lo: int
    box_hi: int
    model: Dict[str, int]
    max_obj: int


SCALES = {
    # full depth and width at a real input resolution class
    "flagship": Scale("flagship", 416, 544, 48, 24, 4, 8, 30, 110,
                      {"enc_layers": 6, "dec_layers": 6, "hidden_dim": 288,
                       "nheads": 8, "dim_feedforward": 1024,
                       "num_queries": 48}, 10),
    # the flagship's width and heads at 2x the small resolution
    "mid": Scale("mid", 192, 256, 32, 20, 4, 6, 24, 64,
                 {"enc_layers": 4, "dec_layers": 4, "hidden_dim": 288,
                  "nheads": 8, "dim_feedforward": 1024, "num_queries": 32},
                 8),
    "small": Scale("small", 96, 128, 24, 16, 4, 4, 18, 40,
                   {"enc_layers": 2, "dec_layers": 2, "hidden_dim": 96,
                    "nheads": 4, "dim_feedforward": 128, "num_queries": 12},
                   6),
}


def make_scene(rng: np.random.RandomState, sc: Scale,
               n_max: Optional[int] = None):
    """One noisy (H, W, 3) float32 image with 1..n_max bright rectangles,
    and their boxes (n, 4) as xywh: the JAX tool's draws, in its order."""
    n_max = sc.n_max if n_max is None else n_max
    img = rng.normal(0.0, 0.3, (sc.h, sc.w, 3)).astype(np.float32)
    n = rng.randint(1, n_max + 1)
    boxes = []
    for _ in range(n):
        bw, bh = rng.randint(sc.box_lo, sc.box_hi), rng.randint(sc.box_lo,
                                                                sc.box_hi)
        x = rng.randint(0, sc.w - bw)
        y = rng.randint(0, sc.h - bh)
        img[y:y + bh, x:x + bw] += rng.uniform(1.0, 2.0) * np.array(
            rng.uniform(0.4, 1.0, 3), np.float32)
        boxes.append([x, y, bw, bh])
    return img, np.array(boxes, np.float32)


def make_scenes(sc: Scale):
    """(train scenes, held-out scenes) from seed 0, as the JAX tool draws
    them."""
    rng = np.random.RandomState(0)
    train = [make_scene(rng, sc) for _ in range(sc.n_train)]
    return train, [make_scene(rng, sc) for _ in range(sc.n_eval)]


def to_targets(boxes_list, sc: Scale, device, max_obj: Optional[int] = None):
    """xywh boxes of each image -> padded `Targets` (normalized cxcywh,
    label 0) on `device`."""
    from ..structures import empty_targets
    max_obj = sc.max_obj if max_obj is None else max_obj
    b = len(boxes_list)
    valid = np.zeros((b, max_obj), bool)
    out = np.zeros((b, max_obj, 4), np.float32)
    for i, bx in enumerate(boxes_list):
        n = min(len(bx), max_obj)
        valid[i, :n] = True
        cx = (bx[:n, 0] + bx[:n, 2] / 2) / sc.w
        cy = (bx[:n, 1] + bx[:n, 3] / 2) / sc.h
        out[i, :n] = np.stack([cx, cy, bx[:n, 2] / sc.w, bx[:n, 3] / sc.h],
                              -1)
    return empty_targets(b, max_obj, device).replace(
        valid=torch.as_tensor(valid, device=device),
        boxes=torch.as_tensor(out, device=device))


def take_rows(targets, idx: torch.Tensor):
    """The images `idx` of padded `Targets`."""
    return targets.replace(**{
        f.name: getattr(targets, f.name).index_select(0, idx)
        for f in dataclasses.fields(targets)
        if getattr(targets, f.name) is not None})


def mode_over(mode: str) -> dict:
    """Config overrides of a mode name: `exact` the MSDA encoder, `fast`
    the windowed one; tokens after it as in the module docstring (`wN` the
    window side; `f32` and `remat0` add no override: `train_config` reads
    them)."""
    from ..ops.window_attn import WINDOW_SIDES
    over = {"tpu.encoder_attention": ("msda" if mode.split("_")[0] == "exact"
                                      else "windowed")}
    for tok in mode.split("_")[1:]:
        if tok.startswith("w") and tok[1:].isdigit():
            if int(tok[1:]) not in WINDOW_SIDES:
                raise NotImplementedError(
                    f"{mode}: kernel #8 is instantiated at window sides "
                    f"{WINDOW_SIDES}, not {tok[1:]}")
            over["tpu.encoder_window"] = int(tok[1:])
        elif tok not in ("f32", "remat0"):
            raise ValueError(f"unknown ablation token {tok!r} in {mode!r}")
    return over


def train_config(mode: str, sc: Scale, steps: int) -> Tuple[dict, dict]:
    """(the loaded train config, the run's optimizer settings): the JAX
    tool's overrides on `train.yaml` + `deformable`."""
    from ..utils.config import load_config
    lr = float(os.environ.get("AGREE_LR", "4e-4"))
    warmup = int(os.environ.get("AGREE_WARMUP", "0"))
    over = {**sc.model, "dataset": "mot", "aux_loss": True, "lr": lr,
            "lr_backbone": lr, "dropout": 0.0,
            "tpu.decoder_attention": "msda",
            "tpu.lr_warmup_steps": warmup, **mode_over(mode)}
    cfg = load_config("train.yaml", ["deformable"], over)
    toks = mode.split("_")[1:]
    cfg["tpu"]["compute_dtype"] = ("bfloat16" if sc.name == "flagship"
                                  and "f32" not in toks else "float32")
    cfg["tpu"]["remat"] = sc.name == "flagship" and "remat0" not in toks
    # the JAX tool scans the layers at these scales for its compile time;
    # the port runs the same math unrolled either way
    cfg["tpu"]["scan_layers"] = sc.name in ("flagship", "mid")
    return cfg, {"lr": lr, "lr_warmup_steps": warmup,
                 "lr_drop_steps": [int(steps * 0.8)]}


def _tag(sc: Scale, steps: int, mode: str, seed: int) -> str:
    return (f"agreement_{sc.name}_{steps}_{mode}"
            + (f"_s{seed}" if seed else ""))


def save_train(path: Path, state, it: int, losses: List[float]) -> None:
    """The train state (master weights, moments, update count), the next
    step and the loss history, written atomically."""
    tmp = path.with_suffix(".tmp")
    torch.save({"params": state.params, "mu": state.mu, "nu": state.nu,
                "step": state.step, "it": it, "losses": losses}, tmp)
    tmp.replace(path)


def restore_train(path: Path, state, model) -> Tuple[int, List[float]]:
    """Load `save_train`'s file into `state` and the model's tensors in
    place -> (the next step, the loss history)."""
    from ..engine.train_step import train_tensors
    blob = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for part in ("params", "mu", "nu"):
            for name, t in getattr(state, part).items():
                t.copy_(blob[part][name])
        for name, t in train_tensors(model).items():
            if t.data_ptr() != state.params[name].data_ptr():
                t.copy_(state.params[name])
    state.step = int(blob["step"])
    return int(blob["it"]), [float(v) for v in blob["losses"]]


def train_and_eval(mode: str, train_scenes, eval_scenes, sc: Scale,
                   steps: int, device, ckpt_dir: Optional[Path],
                   seed: int = 0, max_steps: int = 10 ** 9, log=print):
    """Train one arm for `steps` (the first `max_steps` of them) and
    predict the held-out scenes -> (predictions by scene, losses)."""
    from ..engine import TrainState, make_optimizer, make_train_step
    from ..models import build_model
    from ..structures import FrameBatch
    from ..utils.config import FlagshipConfig

    device = torch.device(device)
    cfg, opt_cfg = train_config(mode, sc, steps)
    model_cfg = FlagshipConfig.from_config(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    model, crit_cfg, post, _ = build_model(model_cfg, device, generator=gen,
                                           train=True)
    opt = make_optimizer(model_cfg, model,
                         lr_drop_steps=opt_cfg["lr_drop_steps"])
    state = TrainState.create(model, opt)
    step = make_train_step(model, crit_cfg, opt, tracking=False)

    start, losses = 0, []
    tck = None
    if ckpt_dir is not None:
        tck = Path(ckpt_dir) / (_tag(sc, steps, mode, seed) + "_train.pt")
        if tck.exists():
            start, losses = restore_train(tck, state, model)
            log(f"{mode}: resuming at step {start} from {tck}")

    # the scenes on the device once; each step takes its batch there
    scenes_dev = torch.as_tensor(np.stack([s[0] for s in train_scenes]),
                                 device=device)
    targets_all = to_targets([s[1] for s in train_scenes], sc, device)
    sizes = torch.tensor([[sc.h, sc.w]] * sc.batch, device=device)
    mask = FrameBatch.from_images(scenes_dev[:sc.batch], sizes).mask
    pend: List[torch.Tensor] = []

    def drain():
        losses.extend(float(v) for v in pend)
        pend.clear()

    order = np.random.RandomState(seed + 1)
    end = min(steps, max(start, max_steps))
    t0 = time.perf_counter()
    for it in range(steps):
        idx = order.choice(len(train_scenes), sc.batch, replace=False)
        if it < start or it >= end:
            continue
        if it % 100 == 0:
            drain()
            log(f"{mode} step {it}/{steps}"
                + (f" (budget {end})" if end < steps else "")
                + (f" loss {losses[-1]:.3f}" if losses else "")
                + f" {time.perf_counter() - t0:.1f} s")
        idx_dev = torch.as_tensor(idx, device=device)
        pack = {"batch": FrameBatch(
            images=scenes_dev.index_select(0, idx_dev), mask=mask),
            "targets": take_rows(targets_all, idx_dev)}
        state, metrics = step(state, pack, gen)
        pend.append(metrics["loss"])
        if tck is not None and ((it + 1) % SAVE_EVERY == 0
                                or it + 1 == end):
            drain()
            save_train(tck, state, it + 1, losses)
    drain()
    if losses:
        log(f"{mode}: loss {np.mean(losses[:10]):.3f} -> "
            f"{np.mean(losses[-10:]):.3f} ({len(losses)} steps, this run "
            f"{time.perf_counter() - t0:.1f} s)")
    return predict(model, post, eval_scenes, sc, device), losses


@torch.no_grad()
def predict(model, post, scenes, sc: Scale, device) -> Dict[int, dict]:
    """The model's detections on `scenes` in chunks of the batch size (the
    last chunk padded with blank images): boxes (Q, 4) xyxy in pixels,
    scores and labels by scene index."""
    from ..structures import FrameBatch
    model.eval()
    sizes = torch.tensor([[sc.h, sc.w]] * sc.batch, device=device)
    imgs = np.stack([s[0] for s in scenes])
    out = {}
    for lo in range(0, len(scenes), sc.batch):
        chunk = imgs[lo:lo + sc.batch]
        if len(chunk) < sc.batch:
            chunk = np.concatenate(
                [chunk, np.zeros_like(chunk[:sc.batch - len(chunk)])])
        batch = FrameBatch.from_images(
            torch.as_tensor(chunk, device=device), sizes)
        res = post(model(batch)[0], sizes)
        for j in range(min(sc.batch, len(scenes) - lo)):
            out[lo + j] = {k: res[k][j].float().cpu().numpy()
                           if k != "labels" else res[k][j].cpu().numpy()
                           for k in ("boxes", "scores", "labels")}
    return out


def eval_map(preds, gt_by_img, sc: Scale) -> Tuple[float, float]:
    """AP@[.5:.95] and AP50 through the port's evaluator against a minimal
    ground-truth facade."""
    from ..datasets.coco_eval import CocoEvaluator

    class GT:
        pass

    gt = GT()
    gt.anns_by_image = gt_by_img
    gt.images = {i: {"height": sc.h, "width": sc.w} for i in gt_by_img}
    ev = CocoEvaluator(gt, ["bbox"])
    ev.update(preds)
    stats = ev.summarize()
    return float(stats["bbox"][0]), float(stats["bbox"][1])


def boxes_to_anns(scenes) -> Dict[int, list]:
    out, aid = {}, 0
    for i, (_, boxes) in enumerate(scenes):
        anns = []
        for b in boxes:
            anns.append({"id": aid, "image_id": i, "category_id": 0,
                         "bbox": [float(v) for v in b],
                         "area": float(b[2] * b[3]), "iscrowd": 0,
                         "ignore": 0})
            aid += 1
        out[i] = anns
    return out


def preds_to_anns(preds, score_thresh: float = 0.5) -> Dict[int, list]:
    """Detections -> pseudo ground truth for the cross-agreement metric:
    label-0 detections at or above the threshold (the focal postprocess
    takes its max over the background column too, so consumers filter by
    label)."""
    out, aid = {}, 0
    for i, p in preds.items():
        anns = []
        keep = (p["scores"] >= score_thresh) & (p["labels"] == 0)
        for b in p["boxes"][keep]:
            x0, y0, x1, y1 = [float(v) for v in b]
            anns.append({"id": aid, "image_id": i, "category_id": 0,
                         "bbox": [x0, y0, x1 - x0, y1 - y0],
                         "area": float((x1 - x0) * (y1 - y0)),
                         "iscrowd": 0, "ignore": 0})
            aid += 1
        out[i] = anns
    return out


def run_mode_cached(mode, train_scenes, eval_scenes, sc, steps, device,
                    ckpt_dir, seed, max_steps, log=print):
    """`train_and_eval` with its predictions kept in `ckpt_dir`, so that a
    finished arm is not trained again."""
    path = None if ckpt_dir is None else \
        Path(ckpt_dir) / (_tag(sc, steps, mode, seed) + ".npz")
    if path is not None and path.exists():
        with np.load(path) as z:
            preds = {i: {"boxes": z[f"b{i}"], "scores": z[f"s{i}"],
                         "labels": z[f"l{i}"]} for i in range(int(z["n"]))}
            losses = [float(v) for v in z["losses"]]
        log(f"{mode}: reusing {path}")
        return preds, losses
    preds, losses = train_and_eval(mode, train_scenes, eval_scenes, sc,
                                   steps, device, ckpt_dir, seed, max_steps,
                                   log)
    if path is not None:
        arrs = {"n": np.array(len(preds)), "losses": np.array(losses)}
        for i, pr in preds.items():
            arrs[f"b{i}"], arrs[f"s{i}"], arrs[f"l{i}"] = (
                pr["boxes"], pr["scores"], pr["labels"])
        np.savez(path, **arrs)
    return preds, losses


def card() -> Optional[str]:
    """`nvidia-smi`'s name and power limit of the card, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def out_path(sc: Scale, seed: int) -> Path:
    """Where a run's result goes: the repository root, or the temporary
    directory for the `small` scale."""
    if sc.name == "small":
        return Path(tempfile.gettempdir()) / (
            f"AGREEMENT_torch_small_s{seed}.json" if seed
            else "AGREEMENT_torch_small.json")
    return REPO / (f"AGREEMENT_torch_s{seed}.json" if seed
                   else "AGREEMENT_torch.json")


def merge_write(path: Path, section: Optional[str], result: dict) -> dict:
    """Write `result` into the JSON at `path` (under `section`, or as its
    top level keeping the other sections)."""
    merged = json.loads(path.read_text()) if path.exists() else {}
    if section is None:
        keep = {k: v for k, v in merged.items() if k == "tracking"}
        merged = {**result, **keep}
    else:
        merged[section] = result
    path.write_text(json.dumps(merged, indent=2))
    return merged


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("steps", type=int, nargs="?", default=350)
    ap.add_argument("scale", nargs="?", default="small",
                    choices=sorted(SCALES))
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory of the resumable train states and each "
                         "arm's predictions")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="result file (default: "
                    "AGREEMENT_torch.json, or under the temporary directory "
                    "at the small scale)")
    args = ap.parse_args(argv)
    sc = SCALES[args.scale]
    seed = int(os.environ.get("AGREE_SEED", "0"))
    max_steps = int(os.environ.get("AGREE_MAX_STEPS", str(10 ** 9)))
    ckpt_dir = None
    if args.ckpt_dir:
        ckpt_dir = Path(args.ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    def log(msg):
        print(msg, flush=True)

    train_scenes, eval_scenes = make_scenes(sc)
    gt = boxes_to_anns(eval_scenes)
    only = os.environ.get("AGREE_MODES")
    arms = {}
    for mode in ("exact", "fast"):
        if only and mode not in only.split(","):
            continue
        arms[mode] = run_mode_cached(mode, train_scenes, eval_scenes, sc,
                                     args.steps, args.device, ckpt_dir, seed,
                                     max_steps, log)
    if set(arms) != {"exact", "fast"}:
        log(f"AGREE_MODES={only}: stopping before the other arm")
        return {}
    (exact_preds, exact_losses), (fast_preds, fast_losses) = (
        arms["exact"], arms["fast"])
    exact_ap, exact_ap50 = eval_map(exact_preds, gt, sc)
    fast_ap, fast_ap50 = eval_map(fast_preds, gt, sc)
    cross_ap, cross_ap50 = eval_map(fast_preds, preds_to_anns(exact_preds),
                                    sc)
    steps_trained = min(args.steps, max_steps)
    ablations = {}
    for mode in filter(None, os.environ.get("AGREE_ABLATIONS",
                                            "").split(",")):
        preds, losses = run_mode_cached(mode, train_scenes, eval_scenes, sc,
                                        args.steps, args.device, ckpt_dir,
                                        seed, max_steps, log)
        ap_, ap50 = eval_map(preds, gt, sc)
        ablations[mode] = {"map": round(ap_, 4), "ap50": round(ap50, 4),
                           "final_loss": round(float(np.mean(losses[-10:])),
                                               4)}
    result = {
        "task": (f"synthetic {sc.w}x{sc.h} rectangle detection, "
                 f"{sc.n_train} train / {sc.n_eval} held-out scenes, "
                 f"{steps_trained} steps each mode"),
        "package": "trackformer_tpu_torch",
        "device": card() if torch.device(args.device).type == "cuda"
        else "cpu",
        "agreement_scale": sc.name,
        "steps_trained": steps_trained,
        "seed": seed,
        "model": dict(sc.model),
        "optimizer": {"lr": float(os.environ.get("AGREE_LR", "4e-4")),
                      "lr_warmup_steps": int(os.environ.get(
                          "AGREE_WARMUP", "0"))},
        "exact_map": round(exact_ap, 4),
        "fast_map": round(fast_ap, 4),
        "exact_ap50": round(exact_ap50, 4),
        "fast_ap50": round(fast_ap50, 4),
        "cross_agreement_map": round(cross_ap, 4),
        "cross_agreement_ap50": round(cross_ap50, 4),
        "exact_final_loss": round(float(np.mean(exact_losses[-10:])), 4),
        "fast_final_loss": round(float(np.mean(fast_losses[-10:])), 4),
        "exact_first_loss": round(float(np.mean(exact_losses[:10])), 4),
        "fast_first_loss": round(float(np.mean(fast_losses[:10])), 4),
    }
    if ablations:
        result["ablations"] = ablations
    path = Path(args.out) if args.out else out_path(sc, seed)
    merge_write(path, None, result)
    log(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
