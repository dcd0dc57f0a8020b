"""Stitch the frames that `plot_sequence` writes into a video.

Counterpart of `tools/make_video.py`, through the port's
`utils/track_utils.write_video` (OpenCV's MJPG writer, or the frames'
directory as it is where OpenCV is absent).

Usage:
  python -m trackformer_tpu_torch.tools.make_video FRAME_DIR OUT.avi \\
      [--fps 25]
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from ..utils.track_utils import write_video

    ap = argparse.ArgumentParser()
    ap.add_argument("frame_dir")
    ap.add_argument("out")
    ap.add_argument("--fps", type=float, default=25.0)
    args = ap.parse_args(argv)
    written = write_video(args.frame_dir, args.out, args.fps)
    print(f"wrote {written}")
    return written


if __name__ == "__main__":
    main()
