"""The epoch loops: training and evaluation.

Counterpart of `trackformer_tpu/engine/loop.py`:

  * `train_one_epoch`: the loop over the loader, the abort on a non-finite
    loss, the metrics' averages (`utils/metrics.py:MetricLogger`), and a
    `torch.profiler` trace of a few steady steps where the JAX package
    starts its own;
  * `make_results`: model outputs -> per-image detections at the original
    size, object-query slots only, 1-based labels, and with
    `postprocess_segm` each query's mask cropped to the image, rescaled to
    its original size and RLE-encoded;
  * `evaluate`: the eval forward (the model in eval mode, under
    `torch.inference_mode`), the criterion's losses as the JAX `eval_step`
    computes them, COCO box AP (`datasets/coco_eval.py`), mask AP for a
    mask model (`masks`) and, for a tracking model with `tracking_eval`,
    the in-process tracking eval: the port's `cli.track` re-entered with
    the live model, its MOTA and IDF1; and with a `panoptic`
    postprocessor, PQ / SQ / RQ of `datasets/panoptic_eval.py`.
"""
from __future__ import annotations

import math
import os
import sys
import tempfile
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..models.criterion import compute_losses
from ..utils.metrics import MetricLogger


def train_one_epoch(train_step: Callable, state, loader: Iterable[Dict],
                    device_put: Callable[[Dict], Dict], epoch: int,
                    generator: Optional[torch.Generator],
                    print_freq: int = 50, profile_dir: str = "",
                    profile_steps: int = 8, vis=None, debug: bool = False):
    """One training epoch -> (state, the metrics' averages). `device_put`
    moves a pack of the loader onto the model's device. With `profile_dir`
    a `torch.profiler` trace of steps [2, 2 + profile_steps) is written
    there as a Chrome trace. The metrics of every printed step go to
    `vis.log_iter`; `debug` ends the epoch after two steps."""
    logger = MetricLogger(print_freq)
    total = len(loader) if hasattr(loader, "__len__") else None
    profiler = None

    def stop_profiler():
        profiler.stop()
        path = f"{profile_dir}/train_epoch{epoch}.json"
        profiler.export_chrome_trace(path)
        print(f"profiler trace written to {path}")

    for step, pack in enumerate(loader):
        if profile_dir and step == 2:
            profiler = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            profiler.start()
        state, metrics = train_step(state, device_put(pack), generator)
        loss_value = float(metrics["loss"])
        if profiler is not None and step >= 2 + profile_steps - 1:
            stop_profiler()
            profiler = None
        values = {k: float(v) for k, v in metrics.items()
                  if not k.startswith("_")}
        if not math.isfinite(loss_value):
            if profiler is not None:
                stop_profiler()
            print(f"Loss is {loss_value}, stopping training")
            print(values)
            sys.exit(1)
        logger.update(**values)
        if print_freq and (step % print_freq == 0 or step + 1 == total):
            print(f"Epoch: [{epoch}] step {step} " + " ".join(
                f"{k}={v:.4f}" for k, v in values.items()), flush=True)
            if vis is not None:
                vis.log_iter({k: m.value for k, m in logger.meters.items()})
        if debug and step >= 1:
            break
    if profiler is not None:  # the epoch was shorter than the trace window
        stop_profiler()
    return state, {k: m.global_avg for k, m in logger.meters.items()}


def make_results(outputs: Dict, targets, postprocess: Callable,
                 num_object_queries: int, postprocess_segm=None,
                 batch=None) -> Dict[int, dict]:
    """Model outputs -> {image id: {"boxes" xyxy at the original size,
    "scores", "labels" (1-based category ids)}} as numpy. Only the
    object-query slots (the last `num_object_queries`) feed detection
    eval; track-query slots before them are dropped. With
    `postprocess_segm` and the `batch`, "masks": each query's mask
    probabilities at the padded size, cropped to the image's valid part,
    resized (bilinear, Pillow) to its original size and thresholded at
    0.5, as RLE dicts."""
    res = postprocess(outputs, targets.orig_size)
    boxes = res["boxes"][:, -num_object_queries:].float().cpu().numpy()
    scores = res["scores"][:, -num_object_queries:].float().cpu().numpy()
    labels = res["labels"][:, -num_object_queries:].cpu().numpy()
    out = {}
    for i, img_id in enumerate(targets.image_id.cpu().numpy()):
        out[int(img_id)] = {"boxes": boxes[i], "scores": scores[i],
                            "labels": labels[i] + 1}
    if postprocess_segm is not None and batch is not None \
            and "pred_masks" in outputs:
        from PIL import Image

        from ..utils import rle
        segm = postprocess_segm({}, outputs, batch.images.shape[1:3],
                                return_probs=True)
        probs = segm["masks"][:, -num_object_queries:].float().cpu().numpy()
        sizes = targets.size.cpu().numpy()
        origs = targets.orig_size.cpu().numpy()
        for i, img_id in enumerate(targets.image_id.cpu().numpy()):
            h_i, w_i = int(sizes[i, 0]), int(sizes[i, 1])
            oh, ow = int(origs[i, 0]), int(origs[i, 1])
            rles = []
            for q in range(probs.shape[1]):
                m = probs[i, q, :h_i, :w_i]
                if (oh, ow) != (h_i, w_i):
                    m = np.asarray(Image.fromarray(m).resize(
                        (ow, oh), Image.BILINEAR))
                rles.append(rle.encode_mask(m > 0.5))
            out[int(img_id)]["masks"] = rles
    return out


def evaluate(model: torch.nn.Module, criterion_cfg, postprocessors: Dict,
             loader: Iterable[Dict], device_put: Callable[[Dict], Dict],
             gt_dataset, args, vis=None, obj_detector_model=None) -> Dict:
    """Evaluate `model` over `loader` (packs of `batch` and `targets`;
    `device_put` moves one onto the model's device) against `gt_dataset`
    (`.anns_by_image`, COCO boxes): the losses' averages, the 12 COCO
    box statistics (`coco_eval_bbox`), `AP` and `AP50`; with `masks` (and
    `postprocessors["segm"]`) also the mask statistics (`coco_eval_masks`)
    and `AP_masks`. `args` carries `num_queries` and optionally
    `vis_and_log_interval` (print frequency), `masks`, `tracking` and
    `tracking_eval`; with the last two, also
    `MOTA` and `IDF1` of the port's `cli.track` over `val_track_dataset`
    (default MOT17-TRAIN-ALL) under `data_root_dir` (default `data`) from
    its middle frame on, with `obj_detector_model` ((model,
    FlagshipConfig, postprocess), the live model) as its detector, on the
    model's device. With `postprocessors["panoptic"]` and a panoptic
    `gt_dataset` (`ann_file`, `ann_folder`) also `PQ_all`, `SQ_all` and
    `RQ_all` over the object queries' panoptic predictions, whose PNGs go
    to `<args.output_dir>/panoptic_eval` (with no `output_dir`, to a
    temporary directory removed afterwards). The model is left in the mode
    it came in."""
    from ..datasets.coco_eval import CocoEvaluator

    logger = MetricLogger(getattr(args, "vis_and_log_interval", 50),
                          vis=vis, debug=getattr(args, "debug", False))
    with_masks = bool(getattr(args, "masks", False))
    evaluator = CocoEvaluator(gt_dataset,
                              ("bbox", "segm") if with_masks else ("bbox",))
    logged = set(criterion_cfg.weight_dict) | {"class_error",
                                               "cardinality_error"}
    panoptic, scratch = None, None
    if "panoptic" in postprocessors and hasattr(gt_dataset, "ann_file"):
        from ..datasets.panoptic_eval import PanopticEvaluator
        out_dir = getattr(args, "output_dir", None)
        if not out_dir:
            scratch = tempfile.TemporaryDirectory()
            out_dir = scratch.name
        panoptic = PanopticEvaluator(
            str(gt_dataset.ann_file), str(gt_dataset.ann_folder),
            output_dir=os.path.join(out_dir, "panoptic_eval"))
    was_training = model.training
    model.eval()
    try:
        for pack in logger.log_every(loader, "Test:"):
            pack = device_put(pack)
            with torch.inference_mode():
                out, targets, _, _, _ = model(pack["batch"], pack["targets"])
                losses = compute_losses(out, targets, criterion_cfg)
            logger.update(**{k: float(v) for k, v in losses.items()
                             if k in logged})
            evaluator.update(make_results(
                out, pack["targets"], postprocessors["bbox"],
                args.num_queries,
                postprocess_segm=(postprocessors.get("segm") if with_masks
                                  else None), batch=pack["batch"]))
            if panoptic is not None:
                tg = pack["targets"]
                obj_out = {k: out[k][:, -args.num_queries:].float().cpu()
                           .numpy() for k in ("pred_logits", "pred_masks")}
                preds = postprocessors["panoptic"](
                    obj_out, processed_sizes=tg.size.cpu().tolist(),
                    target_sizes=tg.orig_size.cpu().tolist())
                for p, img_id in zip(preds, tg.image_id.cpu().tolist()):
                    p["image_id"] = int(img_id)
                panoptic.update(preds)
        logger.synchronize_between_processes()
        evaluator.synchronize_between_processes()
        coco_stats = evaluator.summarize()
        stats = {k: m.global_avg for k, m in logger.meters.items()}
        stats["coco_eval_bbox"] = coco_stats["bbox"]
        stats["AP"] = coco_stats["bbox"][0]
        stats["AP50"] = coco_stats["bbox"][1]
        if "segm" in coco_stats:
            stats["coco_eval_masks"] = coco_stats["segm"]
            stats["AP_masks"] = coco_stats["segm"][0]
        if panoptic is not None:
            panoptic.synchronize_between_processes()
            pq = panoptic.summarize()
            stats.update(PQ_all=pq["PQ"], SQ_all=pq["SQ"], RQ_all=pq["RQ"])
        if getattr(args, "tracking", False) \
                and getattr(args, "tracking_eval", False):
            stats.update(tracking_eval(model, args, obj_detector_model))
    finally:
        model.train(was_training)
        if scratch is not None:
            scratch.cleanup()
    return stats


def tracking_eval(model: torch.nn.Module, args, obj_detector_model) -> Dict:
    """MOTA and IDF1 of the port's `cli.track` run in-process (see
    `evaluate`); {} where the dataset has no ground truth."""
    from ..cli import track as track_cli
    print("TRACK SEQS (in-process tracking eval)")
    dataset = getattr(args, "val_track_dataset", "MOT17-TRAIN-ALL")
    root = getattr(args, "data_root_dir", "data")
    summary = track_cli.main(
        ["with", f"dataset_name={dataset}", f"data_root_dir={root}",
         "frame_range.start=0.5", "output_dir=null"],
        obj_detector_model=obj_detector_model,
        device=next(model.parameters()).device)
    if summary and "OVERALL" in summary:
        return {"MOTA": summary["OVERALL"]["mota"],
                "IDF1": summary["OVERALL"]["idf1"]}
    return {}
