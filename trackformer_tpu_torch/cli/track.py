"""Tracking / evaluation CLI.

Counterpart of `trackformer_tpu/cli/track.py`: load the detector from a
checkpoint and the `config.yaml` saved beside it, run the tracker over
every sequence of the named dataset, write MOTChallenge (or, for a mask
model on MOTS20, MOTS) result files, optionally interpolate and render
frames, accumulate CLEAR-MOT / IDF1 metrics, and print each sequence's
runtime and the overall Hz. With
`tpu.batch_sequences` > 1 the sequences run in lockstep groups of equal
frame shape through `BatchedTracker`.

Usage: python -m trackformer_tpu_torch.cli.track with [named_cfgs...] k=v ...

The model runs on the card unless the caller of `main` passes
`device="cpu"`. A mask model (`masks` in its train config) tracks with
masks, rescaled to each sequence's frames (`upscale_mask_results`) before
they are written. With `generate_attention_maps` (vanilla DETR only, as in
the JAX package) the `Tracker` runs the model as an `AttentionMapDETR` and
each result entry carries its track's attention map, which `write_images`
overlays on the frames (the lockstep `BatchedTracker` keeps none, as in
the JAX package). Over several processes (launched as `cli/train.py`
says, or re-entered from a training run's evaluation) the sequences are
dealt round-robin over the data ranks, and the MOT accumulators gathered,
in the dataset's order, so that every rank reports the global metrics.
"""
from __future__ import annotations

import os.path as osp
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np


def main(argv=None, obj_detector_model=None, device="cuda"):
    """Track the configured dataset -> the MOT summary (None without ground
    truth). `obj_detector_model`: an already built (model, FlagshipConfig,
    postprocess) in place of the checkpoint."""
    import torch
    import yaml

    from ..datasets.tracking import TrackDatasetFactory
    from ..models import build_model
    from ..models.detr import AttentionMapDETR
    from ..parallel import dist as pdist
    from ..tracking import Tracker
    from ..utils import track_utils
    from ..utils.checkpoint import load_model_npz
    from ..utils.config import (FlagshipConfig, dump_config, load_config,
                                namespace_to_dict, nested_namespace,
                                parse_cli)

    if obj_detector_model is None:
        # the process group of the launcher's environment (none: one
        # process); a training run's evaluation has joined its own
        device = pdist.init_process_group(device)
    layout = pdist.layout()
    cfg = parse_cli(argv or sys.argv[1:], base="track.yaml")
    args = nested_namespace(cfg)
    np.random.seed(args.seed)

    if args.output_dir:
        dump_config(cfg, Path(args.output_dir) / "track.yaml")

    # --- detector -------------------------------------------------------
    if obj_detector_model is None:
        ckpt_file = args.obj_detect_checkpoint_file
        cfg_path = (osp.join(osp.dirname(ckpt_file), "config.yaml")
                    if ckpt_file else None)
        if cfg_path and osp.exists(cfg_path):
            with open(cfg_path) as f:
                train_cfg = yaml.safe_load(f)
        else:
            train_cfg = load_config("train.yaml",
                                    ["deformable", "tracking", "multi_frame"])
        train_args = FlagshipConfig.from_config(train_cfg)
        loaded = bool(ckpt_file) and osp.exists(ckpt_file)
        gen = None if loaded else \
            torch.Generator(device=device).manual_seed(args.seed)
        model, postprocess = build_model(train_args, device, generator=gen)
        if loaded:
            load_model_npz(model, ckpt_file)
            print(f"loaded detector weights: {ckpt_file}")
        else:
            print(f"WARNING: checkpoint {ckpt_file!r} not found - "
                  "running with random weights")
    else:
        model, train_args, postprocess = obj_detector_model
    if args.generate_attention_maps and train_args.deformable:
        raise ValueError("attention maps are only available for vanilla "
                         "DETR, as in the JAX package")

    tracker_cfg = namespace_to_dict(args.tracker_cfg)
    tpu_cfg = namespace_to_dict(getattr(args, "tpu", None)) or {}
    tracker_cfg["max_tracks"] = tpu_cfg.get("max_tracks", 150)
    tracker_args = (model, postprocess, tracker_cfg, train_args.hidden_dim,
                    train_args.num_queries, train_args.overflow_boxes,
                    train_args.masks)

    def upscale(results, seq, first: int):
        """A mask model's results with their masks at the frame's size."""
        if not train_args.masks:
            return results
        blob = seq[first]
        return track_utils.upscale_mask_results(
            results, np.asarray(blob["size"]).reshape(-1),
            np.asarray(blob["orig_size"]).reshape(-1),
            blob["batch"].images.shape[1:3])

    dataset = TrackDatasetFactory(
        args.dataset_name, root_dir=args.data_root_dir,
        img_transform=SimpleNamespace(val_width=train_args.val_width,
                                      max_size=train_args.max_size))
    # this data rank's sequences, by their index in the dataset
    mine = [(i, seq) for i, seq in enumerate(dataset)
            if i % layout.data_size == layout.data_rank]

    def summarize(accums):
        """The metrics of every rank's (index, accumulator, name), or None
        without ground truth; gathered from several ranks, in the
        dataset's order."""
        merged = accums if layout.data_size == 1 else sorted(
            (a for part in pdist.all_gather_objects(accums,
                                                    layout.data_group)
             for a in part), key=lambda a: a[0])
        if not merged:
            return None
        print("EVAL:")
        return track_utils.evaluate_mot_accums([a[1] for a in merged],
                                               [a[2] for a in merged])

    # batched multi-sequence throughput mode (tracking/batched.py)
    batch_seqs = int(tpu_cfg.get("batch_sequences", 1) or 1)
    if batch_seqs > 1 and args.load_results_dir is None:
        from ..tracking.batched import BatchedTracker, group_by_shape
        bt = BatchedTracker(*tracker_args)
        accums = []
        index_of = {id(seq): i for i, seq in mine}
        time_total, num_frames = 0.0, 0
        for group in group_by_shape([seq for _, seq in mine], batch_seqs):
            t0 = time.time()
            group_results = bt.run(
                group, (args.frame_range.start, args.frame_range.end))
            t = time.time() - t0
            n = sum(len(s) for s in group)
            time_total += t
            num_frames += n
            print(f"BATCHED GROUP x{len(group)}: {t:.2f} s "
                  f"({n / max(t, 1e-9):.2f} Hz)")
            for seq, results in zip(group, group_results):
                results = upscale(results, seq,
                                  int(len(seq) * args.frame_range.start))
                if args.interpolate:
                    results = track_utils.interpolate_tracks(results)
                if args.output_dir is not None:
                    seq.write_results(results, args.output_dir)
                if not seq.no_gt:
                    accums.append((index_of[id(seq)],
                                   track_utils.get_mot_accum(results, seq),
                                   str(seq)))
        print(f"RUNTIME ALL SEQS: {time_total:.2f} s for {num_frames} "
              f"frames ({num_frames / max(time_total, 1e-9):.2f} Hz)")
        return summarize(accums)

    if args.generate_attention_maps:
        attn_model = AttentionMapDETR(model)
        tracker = Tracker(attn_model, *tracker_args[1:],
                          attn_stride=attn_model.stride)
    else:
        tracker = Tracker(*tracker_args)
    time_total, num_frames = 0.0, 0
    accums = []
    for index, seq in mine:
        tracker.reset()
        n = len(seq)
        start = int(n * args.frame_range.start)
        end = int(n * args.frame_range.end)

        results = seq.load_results(args.load_results_dir)
        if not results:
            t0 = time.time()
            for i in range(start, end):
                tracker.step(seq[i])
                num_frames += 1
            results = tracker.get_results()
            t = time.time() - t0
            time_total += t
            print(f"NUM TRACKS: {len(results)} ReIDs: {tracker.num_reids}")
            print(f"RUNTIME: {t:.2f} s ({(end - start) / max(t, 1e-9):.2f} "
                  f"Hz)")
            results = upscale(results, seq, start)

        if args.interpolate:
            results = track_utils.interpolate_tracks(results)

        if args.output_dir is not None:
            print(f"WRITE RESULTS: {seq}")
            seq.write_results(results, args.output_dir)

        if not seq.no_gt:
            accums.append((index, track_utils.get_mot_accum(results, seq),
                           str(seq)))

        if args.write_images and args.output_dir:
            track_utils.plot_sequence(
                results, seq, osp.join(args.output_dir, str(seq)),
                args.write_images, args.generate_attention_maps)

    if num_frames:
        print(f"RUNTIME ALL SEQS (w/o EVAL or IMG WRITE): "
              f"{time_total:.2f} s for {num_frames} frames "
              f"({num_frames / max(time_total, 1e-9):.2f} Hz)")
    return summarize(accums)


if __name__ == "__main__":
    main()
