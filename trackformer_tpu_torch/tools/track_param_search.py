"""Grid search over the tracker's thresholds.

Counterpart of `tools/track_param_search.py`: runs the port's tracking
CLI (`cli/track.py`) once per combination of `GRID`, appended to the
given arguments as overrides, and reports every run's MOTA and IDF1 and
the combination of the best MOTA (the first such, in the grid's order).

Usage:
  python -m trackformer_tpu_torch.tools.track_param_search with \\
      dataset_name=MOT17-TRAIN-ALL obj_detect_checkpoint_file=... \\
      output_dir=/tmp/search
"""
from __future__ import annotations

import itertools
import json
import sys

GRID = {
    "tracker_cfg.detection_obj_score_thresh": [0.3, 0.4, 0.5],
    "tracker_cfg.track_obj_score_thresh": [0.3, 0.4, 0.5],
    "tracker_cfg.detection_nms_thresh": [0.9],
    "tracker_cfg.track_nms_thresh": [0.9],
}


def search(base_argv, run):
    """`run(argv)` -> a MOT summary, once per combination -> {"best",
    "all"}: each run's params, MOTA and IDF1, and the best by MOTA."""
    keys = sorted(GRID)
    best, results = None, []
    for combo in itertools.product(*(GRID[k] for k in keys)):
        overrides = [f"{k}={v}" for k, v in zip(keys, combo)]
        print("RUN:", overrides)
        summary = run(list(base_argv) + overrides)
        if not summary or "OVERALL" not in summary:
            continue
        mota = summary["OVERALL"]["mota"]
        idf1 = summary["OVERALL"]["idf1"]
        results.append({"params": dict(zip(keys, combo)),
                        "mota": mota, "idf1": idf1})
        if best is None or mota > best["mota"]:
            best = results[-1]
        print(f"  -> MOTA {mota:.1%} IDF1 {idf1:.1%}")
    return {"best": best, "all": results}


def main(argv=None, device="cuda"):
    """Search with the tracking CLI on `device` -> the best run."""
    from ..cli import track as track_cli

    out = search(sys.argv[1:] if argv is None else argv,
                 lambda a: track_cli.main(a, device=device))
    print(json.dumps(out, indent=2))
    return out["best"]


if __name__ == "__main__":
    main()
