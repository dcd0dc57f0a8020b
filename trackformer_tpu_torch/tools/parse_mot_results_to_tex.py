"""MOT result directories -> LaTeX table rows.

Counterpart of `tools/parse_mot_results_to_tex.py`: each directory of
MOTChallenge result files is scored against the named dataset's ground
truth (the port's sequences and CLEAR-MOT / IDF1 metrics) and printed as
one row: MOTA, IDF1, MT, ML, FP, FN, IDSW.

Usage:
  python -m trackformer_tpu_torch.tools.parse_mot_results_to_tex \\
      results_dir1 results_dir2 --dataset MOT17-TRAIN-ALL --data-root data
"""
from __future__ import annotations

import argparse
import os.path as osp


def table_rows(results_dirs, dataset_name: str, data_root: str):
    """The header and one row per directory (a comment line where no
    sequence of the directory has ground truth and results)."""
    from ..datasets.tracking import TrackDatasetFactory
    from ..utils.mot_metrics import summarize
    from ..utils.track_utils import get_mot_accum

    lines = [r"run & MOTA & IDF1 & MT & ML & FP & FN & IDSW \\",
             r"\midrule"]
    for rdir in results_dirs:
        dataset = TrackDatasetFactory(dataset_name, root_dir=data_root,
                                      img_transform=None)
        accums = []
        for seq in dataset:
            results = seq.load_results(rdir)
            if seq.no_gt or not results:
                continue
            accums.append(get_mot_accum(results, seq))
        if not accums:
            lines.append(f"% {rdir}: no evaluable sequences")
            continue
        m = summarize(accums)["OVERALL"]
        lines.append(f"{osp.basename(rdir)} & {m['mota'] * 100:.1f} & "
                     f"{m['idf1'] * 100:.1f} & {m['mostly_tracked']} & "
                     f"{m['mostly_lost']} & {m['num_false_positives']} & "
                     f"{m['num_misses']} & {m['num_switches']} \\\\")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results_dirs", nargs="+")
    ap.add_argument("--dataset", default="MOT17-TRAIN-ALL")
    ap.add_argument("--data-root", default="data")
    args = ap.parse_args(argv)
    lines = table_rows(args.results_dirs, args.dataset, args.data_root)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
