"""Training-log and precision-recall plots.

Counterpart of `trackformer_tpu/utils/plot_utils.py`: `get_vis_win_names`,
the log parsing (`read_logs`: the JSONL stream that `vis.py` writes,
`vis/epoch_metrics.jsonl`, else a `log.txt` of one JSON object a line;
`log_series`: a field's `train_` / `test_` series or the raw field;
`ewm`: pandas' `ewm(com=...).mean()` with `adjust=True`), `plot_logs`,
`plot_precision_recall` over `CocoEvaluator.dump_eval`'s `.npz` files and
`fig_to_numpy`. The plots need matplotlib, which the card's machine does
not have: there they raise `ImportError` saying so (`vis.py` skips its
plot instead), and the parsing runs everywhere.
"""
from __future__ import annotations

import json
from pathlib import Path, PurePath
from typing import Dict, List, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or a clear ImportError."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_utils' plots need matplotlib, which is not "
                          "installed here; read_logs / log_series / ewm "
                          "parse the logs without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def fig_to_numpy(fig) -> np.ndarray:
    """A matplotlib figure rasterized to (H, W, 3) uint8 RGB."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg

    canvas = FigureCanvasAgg(fig)
    canvas.draw()
    w, h = (int(v) for v in canvas.get_width_height(physical=True))
    buf = np.frombuffer(canvas.buffer_rgba(), dtype=np.uint8)
    return buf.reshape(h, w, 4)[..., :3].copy()


def get_vis_win_names(vis_dict: Dict[str, Dict]) -> Dict[str, Dict]:
    """{outer: {inner: vis.win}} for a nested visualizer dict."""
    return {outer_k: {inner_k: getattr(inner_v, "win", None)
                      for inner_k, inner_v in outer_v.items()}
            for outer_k, outer_v in vis_dict.items()}


def ewm(values: np.ndarray, com: float) -> np.ndarray:
    """Exponentially weighted mean, pandas' `ewm(com=...).mean()` with
    `adjust=True`: y_t = sum_i w_i x_i / sum_i w_i, w_i = (1 - a)^(t - i),
    a = 1 / (1 + com); `com` <= 0: the values."""
    if com <= 0:
        return values.astype(np.float64)
    alpha = 1.0 / (1.0 + com)
    out = np.empty(len(values), np.float64)
    num = den = 0.0
    decay = 1.0 - alpha
    for i, v in enumerate(values):
        num = num * decay + v
        den = den * decay + 1.0
        out[i] = num / den
    return out


def read_jsonl(path: Path) -> List[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def read_logs(logs, log_name: str = "vis/epoch_metrics.jsonl"
              ) -> List[List[dict]]:
    """One list of rows per log directory: `log_name` where it exists,
    else `log.txt`. `logs`: a directory or a list of them."""
    func_name = "plot_utils.plot_logs"
    if not isinstance(logs, list):
        if isinstance(logs, (str, PurePath)):
            logs = [logs]
        else:
            raise ValueError(
                f"{func_name} - invalid logs argument of {type(logs)}")
    logs = [Path(p) for p in logs]
    for d in logs:
        if not d.exists():
            raise ValueError(f"{func_name} - invalid directory: {d}")
    return [read_jsonl(p / log_name if (p / log_name).exists()
                       else p / "log.txt") for p in logs]


def log_series(rows: List[dict], field: str, ewm_col: float = 0):
    """-> {"train": .., "test": ..} of `train_<field>` / `test_<field>`
    where either exists, else {"raw": ..}: the scalar values in order,
    smoothed by `ewm(ewm_col)`."""
    def series(key):
        return np.array([r[key] for r in rows if key in r
                         and np.isscalar(r[key])])

    tr, te = series(f"train_{field}"), series(f"test_{field}")
    if len(tr) or len(te):
        return {name: ewm(s, ewm_col) for name, s in
                (("train", tr), ("test", te)) if len(s)}
    raw = series(field)
    return {"raw": ewm(raw, ewm_col)} if len(raw) else {}


def plot_logs(logs, fields: Sequence[str] = ("class_error",
                                             "loss_bbox_unscaled", "mAP"),
              ewm_col: float = 0,
              log_name: str = "vis/epoch_metrics.jsonl"):
    """Selected fields of one or more training-log directories: a subplot
    per field, a color per directory, `train_<field>` solid and
    `test_<field>` dashed where they exist, else the raw field.
    -> (fig, axs)."""
    dfs = read_logs(logs, log_name)
    names = [Path(p).name for p in (logs if isinstance(logs, list)
                                    else [logs])]
    plt = _pyplot()
    fields = list(fields)
    fig, axs = plt.subplots(ncols=len(fields), figsize=(16, 5),
                            squeeze=False)
    axs = axs[0]
    cmap = plt.get_cmap("tab10")
    for li, rows in enumerate(dfs):
        color = cmap(li % 10)
        for j, field in enumerate(fields):
            for kind, values in log_series(rows, field, ewm_col).items():
                axs[j].plot(values, "--" if kind == "test" else "-",
                            color=color)
    for ax, field in zip(axs, fields):
        ax.legend(names)
        ax.set_title(field)
    return fig, axs


def precision_recall_summary(path) -> Dict[str, np.ndarray]:
    """A `dump_eval` `.npz` -> the curves at IoU 0.5, area "all" and the
    last max-detections column, averaged over the categories: "recall"
    (the thresholds), "precision", "scores", and the means "map50",
    "score", "rec"."""
    data = np.load(path)
    precision = data["precision"][0, :, :, 0, -1].mean(1)
    scores = data["scores"][0, :, :, 0, -1].mean(1)
    return {"recall": data["recThrs"], "precision": precision,
            "scores": scores, "map50": precision.mean(),
            "score": scores.mean(),
            "rec": data["recall"][0, :, 0, -1].mean()}


def plot_precision_recall(files, naming_scheme: str = "iter"):
    """Precision / recall and score / recall curves of `dump_eval`'s
    `.npz` files. -> (fig, axs)."""
    files = [Path(f) for f in files]
    if naming_scheme == "exp_id":
        names = [f.parts[-3] for f in files]
    elif naming_scheme == "iter":
        names = [f.stem for f in files]
    else:
        raise ValueError(f"not supported {naming_scheme}")
    plt = _pyplot()
    fig, axs = plt.subplots(ncols=2, figsize=(16, 5))
    cmap = plt.get_cmap("Blues")
    for i, (f, name) in enumerate(zip(files, names)):
        pr = precision_recall_summary(f)
        prec, rec = pr["map50"], pr["rec"]
        print(f"{naming_scheme} {name}: mAP@50={prec * 100: 05.1f}, "
              f"score={pr['score']:0.3f}, "
              f"f1={2 * prec * rec / (prec + rec + 1e-8):0.3f}")
        color = cmap(0.3 + 0.7 * (i + 1) / len(files))
        axs[0].plot(pr["recall"], pr["precision"], c=color)
        axs[1].plot(pr["recall"], pr["scores"], c=color)
    axs[0].set_title("Precision / Recall")
    axs[0].legend(names)
    axs[1].set_title("Scores / Recall")
    axs[1].legend(names)
    return fig, axs
