"""Exact linear-sum assignment (Hungarian), in plain torch on the tensor's
device.

Counterpart of `hungarian` and `hungarian_rect` in
`trackformer_tpu/ops/assignment.py`: the same shortest-augmenting-path
algorithm (the one scipy implements). Its loops are data-dependent, so the
loop control reads a few scalars back to the host; the arithmetic stays on
the device and nothing goes through scipy.
"""
from __future__ import annotations

import torch

# large finite stand-in for a forbidden edge, as in the JAX package
BIG = 1e8
_INF = 3e38


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost assignment for cost (R, C), R <= C -> col4row (R,) int64."""
    r, c = cost.shape
    if r > c:
        raise ValueError(f"hungarian requires R <= C, got {tuple(cost.shape)}")
    dev = cost.device
    cost = cost.float()
    u = torch.zeros(r, device=dev)
    v = torch.zeros(c, device=dev)
    row4col = torch.full((c,), -1, dtype=torch.long, device=dev)
    col4row = torch.full((r,), -1, dtype=torch.long, device=dev)
    rows = torch.arange(r, device=dev)
    for cur_row in range(r):
        # Dijkstra from cur_row to the nearest unassigned column
        i = cur_row
        min_val = torch.zeros((), device=dev)
        shortest = torch.full((c,), _INF, device=dev)
        path = torch.full((c,), -1, dtype=torch.long, device=dev)
        sr = torch.zeros(r, dtype=torch.bool, device=dev)
        sc = torch.zeros(c, dtype=torch.bool, device=dev)
        while True:
            sr[i] = True
            cand = min_val + cost[i] - u[i] - v
            upd = ~sc & (cand < shortest)
            shortest = torch.where(upd, cand, shortest)
            path = torch.where(upd, i, path)
            masked = torch.where(sc, _INF, shortest)
            j = int(masked.argmin())
            min_val = masked[j]
            sc[j] = True
            rj = int(row4col[j])
            if rj < 0:
                sink = j
                break
            i = rj
        # dual potentials
        u[cur_row] += min_val
        others = sr & (rows != cur_row)
        delta_u = min_val - shortest[col4row.clamp(0, c - 1)]
        u = torch.where(others, u + delta_u, u)
        v = torch.where(sc, v - (min_val - shortest), v)
        # augment along the alternating path back to cur_row
        while True:
            i = int(path[sink])
            row4col[sink] = i
            next_sink = int(col4row[i])
            col4row[i] = sink
            sink = next_sink
            if i == cur_row:
                break
    return col4row


def hungarian_rect(cost: torch.Tensor) -> torch.Tensor:
    """Any (R, C) -> (R,) column per row, -1 for rows left unassigned when
    R > C (scipy matches min(R, C) pairs)."""
    r, c = cost.shape
    if r <= c:
        return hungarian(cost)
    row4col = hungarian(cost.T)
    out = torch.full((r,), -1, dtype=torch.long, device=cost.device)
    out[row4col] = torch.arange(c, device=cost.device)
    return out
