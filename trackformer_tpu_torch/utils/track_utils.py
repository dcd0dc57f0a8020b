"""Tracking evaluation glue and offline track utilities.

The port's own copy of the numpy part of `trackformer_tpu/utils/
track_utils.py`: `get_mot_accum` builds a per-sequence accumulator from a
tracker's results and the sequence's ground truth, `evaluate_mot_accums`
summarizes and prints them, `interpolate_tracks` fills frame gaps inside
each track, `upscale_mask_results` takes a mask model's tracker masks to
the original frame size; `plot_sequence` draws the tracked boxes, masks
and attention maps onto the frames and `write_video` stitches the drawn
frames into a video (matplotlib, and ffmpeg or Pillow, imported at the
call).
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from .mot_metrics import (MOTAccumulator, format_summary, iou_distance,
                          summarize)


def get_mot_accum(results: Dict[int, Dict[int, dict]],
                  seq) -> MOTAccumulator:
    """Build a per-frame accumulator from tracker results and sequence GT."""
    acc = MOTAccumulator(name=str(seq))
    for frame_idx in range(len(seq)):
        frame_data = seq.data[frame_idx] if hasattr(seq, "data") else \
            {"gt": {}}
        gt = frame_data.get("gt", {})
        gt_ids = list(gt.keys())
        gt_boxes = np.asarray([gt[i] for i in gt_ids],
                              np.float32).reshape(-1, 4)

        hyp_ids = []
        hyp_boxes = []
        for tid, track in results.items():
            if frame_idx in track:
                hyp_ids.append(tid)
                hyp_boxes.append(np.asarray(track[frame_idx]["bbox"][:4]))
        hyp_boxes = np.asarray(hyp_boxes, np.float32).reshape(-1, 4)

        dist = iou_distance(gt_boxes, hyp_boxes)
        acc.update(gt_ids, hyp_ids, dist)
    return acc


def evaluate_mot_accums(accums: List[MOTAccumulator],
                        names: Optional[List[str]] = None,
                        generate_overall: bool = True) -> Dict:
    summary = summarize(accums, names, generate_overall)
    print(format_summary(summary))
    return summary


def interpolate_tracks(tracks: Dict[int, Dict[int, dict]]) -> Dict:
    """Linearly fill frame gaps inside each track (reference :239-271 —
    which returns after the first track; fixed here)."""
    interpolated: Dict[int, Dict[int, dict]] = {}
    for tid, track in tracks.items():
        interpolated[tid] = {}
        frames = sorted(track.keys())
        if not frames:
            continue
        for f in frames:
            interpolated[tid][f] = track[f]
        for a, b in zip(frames[:-1], frames[1:]):
            if b - a <= 1:
                continue
            box_a = np.asarray(track[a]["bbox"][:4], np.float64)
            box_b = np.asarray(track[b]["bbox"][:4], np.float64)
            for f in range(a + 1, b):
                t = (f - a) / (b - a)
                interpolated[tid][f] = {
                    "bbox": (box_a * (1 - t) + box_b * t).astype(np.float32),
                    "score": track[a].get("score", 1.0),
                }
    return interpolated


def upscale_mask_results(tracks: Dict[int, Dict[int, dict]],
                         size_hw, orig_hw, pad_hw) -> Dict:
    """The tracker's masks, at the mask head's resolution of the padded
    frame `pad_hw`, cropped to the frame's valid part `size_hw` and
    resized (nearest, Pillow) to the original frame size `orig_hw`, for
    the MOTS result files; entries without a mask are kept as they are."""
    from PIL import Image

    h, w = int(size_hw[0]), int(size_hw[1])
    ph, pw = int(pad_hw[0]), int(pad_hw[1])
    oh, ow = int(orig_hw[0]), int(orig_hw[1])
    out: Dict[int, Dict[int, dict]] = {}
    for tid, frames in tracks.items():
        out[tid] = {}
        for fi, data in frames.items():
            data = dict(data)
            if "mask" in data:
                m = np.asarray(data["mask"])
                mh, mw = m.shape
                vh = max(1, int(round(mh * h / ph)))
                vw = max(1, int(round(mw * w / pw)))
                img = Image.fromarray(m[:vh, :vw].astype(np.uint8))
                data["mask"] = np.asarray(
                    img.resize((ow, oh), Image.NEAREST)).astype(bool)
            out[tid][fi] = data
    return out


def plot_sequence(tracks: Dict, seq, output_dir: str,
                  write_images="pretty", generate_attention_maps=False):
    """Draw the tracked boxes (and masks) onto the sequence's frames and
    save them under their own file names. `write_images`: 'debug' adds the
    score to each label. With `generate_attention_maps` each entry's
    "attention_map" is resized to the frame (Pillow, bilinear), divided by
    its largest value, and every pixel above 0.25 takes its track's colour
    at an alpha of half that value, in one overlay over all tracks."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import colormaps

    from PIL import Image

    from ..datasets.image_io import read_frame

    os.makedirs(output_dir, exist_ok=True)
    cmap = colormaps["tab20"]
    for frame_idx in range(len(seq)):
        path = seq[frame_idx]["img_path"]
        img = read_frame(path)
        h, w = img.shape[:2]
        fig, ax = plt.subplots(figsize=(w / 96, h / 96), dpi=96)
        ax.imshow(img)
        ax.axis("off")
        attention_img = (np.zeros((h, w, 4)) if generate_attention_maps
                         else None)
        for tid, track in tracks.items():
            if frame_idx not in track:
                continue
            x1, y1, x2, y2 = track[frame_idx]["bbox"][:4]
            color = cmap(tid % 20)
            ax.add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       fill=False, color=color, lw=2))
            label = str(tid)
            if write_images == "debug":
                label += f" {track[frame_idx].get('score', 0):.2f}"
            ax.text(x1, y1 - 2, label, color=color, fontsize=8)
            if "mask" in track[frame_idx]:
                mask = np.asarray(track[frame_idx]["mask"])
                if mask.shape[:2] != (h, w):
                    mask = np.asarray(Image.fromarray(
                        mask.astype(np.uint8)).resize((w, h)))
                overlay = np.zeros((h, w, 4))
                overlay[mask > 0] = (*color[:3], 0.4)
                ax.imshow(overlay)
            if attention_img is not None \
                    and "attention_map" in track[frame_idx]:
                amap = np.asarray(track[frame_idx]["attention_map"],
                                  np.float32)
                amap = np.asarray(Image.fromarray(amap).resize(
                    (w, h), Image.BILINEAR))
                norm = amap / max(float(amap.max()), 1e-12)
                hot = norm > 0.25
                attention_img[hot] = color
                attention_img[..., 3][hot] = norm[hot] * 0.5
        if attention_img is not None:
            ax.imshow(attention_img, vmin=0.0, vmax=1.0)
        fig.savefig(osp.join(output_dir, osp.basename(path)),
                    bbox_inches="tight", pad_inches=0)
        plt.close(fig)


def write_video(frame_dir: str, out_path: str, fps: float = 25.0) -> str:
    """Stitch the frames written by `plot_sequence` into a video with the
    ffmpeg binary when there is one, else into an animated GIF (Pillow).
    Returns the path written (its extension may change to .gif)."""
    import shutil
    import subprocess

    frames = sorted(p for p in os.listdir(frame_dir)
                    if p.lower().endswith((".jpg", ".jpeg", ".png")))
    if not frames:
        raise ValueError(f"no frames in {frame_dir}")
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps),
             "-pattern_type", "glob",
             "-i", osp.join(frame_dir, "*" + osp.splitext(frames[0])[1]),
             "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path],
            check=True)
        return out_path
    from PIL import Image
    gif_path = osp.splitext(out_path)[0] + ".gif"
    imgs = [Image.open(osp.join(frame_dir, f)).convert("P") for f in frames]
    imgs[0].save(gif_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    for im in imgs:
        im.close()
    return gif_path
