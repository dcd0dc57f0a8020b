"""The epoch loops: training and evaluation.

Counterpart of `trackformer_tpu/engine/loop.py`:

  * `train_one_epoch`: the loop over the loader, the abort on a non-finite
    loss, the metrics' averages (`utils/metrics.py:MetricLogger`), and a
    `torch.profiler` trace of a few steady steps where the JAX package
    starts its own;
  * `make_results`: model outputs -> per-image detections at the original
    size, object-query slots only, 1-based labels;
  * `evaluate`: the eval forward (the model in eval mode, under
    `torch.inference_mode`), the criterion's losses as the JAX `eval_step`
    computes them, and COCO box AP (`datasets/coco_eval.py`).

Masks (`segm`), panoptic evaluation and the in-process tracking eval raise
`NotImplementedError`, naming the ROADMAP Queue 1 item that brings them.
"""
from __future__ import annotations

import math
import sys
from typing import Callable, Dict, Iterable, Optional

import torch

from ..models.criterion import compute_losses
from ..utils.metrics import MetricLogger


def train_one_epoch(train_step: Callable, state, loader: Iterable[Dict],
                    device_put: Callable[[Dict], Dict], epoch: int,
                    generator: Optional[torch.Generator],
                    print_freq: int = 50, profile_dir: str = "",
                    profile_steps: int = 8):
    """One training epoch -> (state, the metrics' averages). `device_put`
    moves a pack of the loader onto the model's device. With `profile_dir`
    a `torch.profiler` trace of steps [2, 2 + profile_steps) is written
    there as a Chrome trace."""
    logger = MetricLogger(print_freq)
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
        if print_freq and step % print_freq == 0:
            print(f"Epoch: [{epoch}] step {step} " + " ".join(
                f"{k}={v:.4f}" for k, v in values.items()), flush=True)
    if profiler is not None:  # the epoch was shorter than the trace window
        stop_profiler()
    return state, {k: m.global_avg for k, m in logger.meters.items()}


def make_results(outputs: Dict, targets, postprocess: Callable,
                 num_object_queries: int,
                 postprocess_segm=None) -> Dict[int, dict]:
    """Model outputs -> {image id: {"boxes" xyxy at the original size,
    "scores", "labels" (1-based category ids)}} as numpy. Only the
    object-query slots (the last `num_object_queries`) feed detection
    eval; track-query slots before them are dropped."""
    if postprocess_segm is not None:
        raise NotImplementedError("mask results (segm) are not ported yet: "
                                  "they come with the masks (ROADMAP Queue "
                                  "1, item 6)")
    res = postprocess(outputs, targets.orig_size)
    boxes = res["boxes"][:, -num_object_queries:].float().cpu().numpy()
    scores = res["scores"][:, -num_object_queries:].float().cpu().numpy()
    labels = res["labels"][:, -num_object_queries:].cpu().numpy()
    out = {}
    for i, img_id in enumerate(targets.image_id.cpu().numpy()):
        out[int(img_id)] = {"boxes": boxes[i], "scores": scores[i],
                            "labels": labels[i] + 1}
    return out


def evaluate(model: torch.nn.Module, criterion_cfg, postprocessors: Dict,
             loader: Iterable[Dict], device_put: Callable[[Dict], Dict],
             gt_dataset, args, vis=None) -> Dict:
    """Evaluate `model` over `loader` (packs of `batch` and `targets`;
    `device_put` moves one onto the model's device) against `gt_dataset`
    (`.anns_by_image`, COCO boxes): the losses' averages, the 12 COCO
    box statistics (`coco_eval_bbox`), `AP` and `AP50`. `args` carries
    `num_queries` and optionally `vis_and_log_interval` (print frequency),
    `masks`, `tracking` and `tracking_eval`. The model is left in the mode
    it came in."""
    from ..datasets.coco_eval import CocoEvaluator

    if getattr(args, "masks", False) or "segm" in postprocessors:
        raise NotImplementedError("mask evaluation (segm) is not ported "
                                  "yet (ROADMAP Queue 1, item 6)")
    if "panoptic" in postprocessors:
        raise NotImplementedError("panoptic evaluation is not ported yet "
                                  "(ROADMAP Queue 1, item 6)")
    if getattr(args, "tracking", False) \
            and getattr(args, "tracking_eval", False):
        raise NotImplementedError("the in-process tracking eval re-enters "
                                  "the track CLI, which is not ported yet "
                                  "(ROADMAP Queue 1, item 8)")
    logger = MetricLogger(getattr(args, "vis_and_log_interval", 50),
                          vis=vis, debug=getattr(args, "debug", False))
    evaluator = CocoEvaluator(gt_dataset, ("bbox",))
    logged = set(criterion_cfg.weight_dict) | {"class_error",
                                               "cardinality_error"}
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
            evaluator.update(make_results(out, pack["targets"],
                                          postprocessors["bbox"],
                                          args.num_queries))
    finally:
        model.train(was_training)
    logger.synchronize_between_processes()
    evaluator.synchronize_between_processes()
    coco_stats = evaluator.summarize()
    stats = {k: m.global_avg for k, m in logger.meters.items()}
    stats["coco_eval_bbox"] = coco_stats["bbox"]
    stats["AP"] = coco_stats["bbox"][0]
    stats["AP50"] = coco_stats["bbox"][1]
    return stats
