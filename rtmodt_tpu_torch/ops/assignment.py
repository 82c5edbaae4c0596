"""Greedy maximum-similarity assignment (port of ``rtmodt_tpu/ops/assignment.py``).

Greedy = repeatedly take the globally best (row, col) pair whose similarity
is >= threshold and retire its row and column.  It runs as parallel
mutual-best rounds: every pair that is each other's argmax (first-index tie
break) is committed at once, which reproduces sequential greedy and needs
typically 2-4 rounds, ``min(R, C)`` at worst.

Loop form: the reference's data-dependent ``lax.while_loop`` becomes a Python
loop bounded at ``min(R, C)`` rounds whose condition (any entry still >=
threshold) is read on the host once per round.  On the card that read is one
device -> host sync per round; fixed ``min(R, C)`` rounds would instead
launch ~100 rounds of kernels per association at the default 256 slots x 100
detections.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1e9


class AssignResult(NamedTuple):
    row_to_col: torch.Tensor  # (R,) int32, -1 if row unmatched
    col_to_row: torch.Tensor  # (C,) int32, -1 if col unmatched
    rounds: int               # mutual-best rounds taken


def greedy_assign(similarity: torch.Tensor, threshold: float,
                  row_valid: torch.Tensor | None = None,
                  col_valid: torch.Tensor | None = None) -> AssignResult:
    """Greedy assignment over a (R, C) similarity matrix; a match requires
    ``similarity >= threshold``; invalid rows/cols never match; NaN entries
    count as -1e9 so one poisoned pair cannot disable the frame."""
    r, c = similarity.shape
    dev = similarity.device
    sim = torch.nan_to_num(similarity.float(), nan=NEG)
    if row_valid is not None:
        sim = torch.where(row_valid[:, None], sim, NEG)
    if col_valid is not None:
        sim = torch.where(col_valid[None, :], sim, NEG)
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    row_to_col = torch.full((r,), -1, dtype=torch.int32, device=dev)
    col_to_row = torch.full((c,), -1, dtype=torch.int32, device=dev)
    if r == 0 or c == 0:
        return AssignResult(row_to_col, col_to_row, 0)
    rows = torch.arange(r, dtype=torch.int32, device=dev)
    rounds = 0
    while rounds < min(r, c) and bool(sim.max() >= thr):
        row_val, row_best = sim.max(dim=1)
        col_best = sim.argmax(dim=0)
        mutual = (col_best[row_best] == rows) & (row_val >= thr)
        row_to_col = torch.where(mutual, row_best.int(), row_to_col)
        # rows that are not mutual scatter into a sink column c, dropped after
        # (mutual pairs have distinct columns); no host sync
        tgt = torch.where(mutual, row_best, c)
        ext = torch.cat([col_to_row, col_to_row.new_full((1,), -1)])
        col_to_row = ext.scatter(0, tgt, rows)[:c]
        col_gone = torch.zeros(c + 1, dtype=torch.bool, device=dev)
        col_gone[tgt] = True
        sim = torch.where(mutual[:, None] | col_gone[None, :c], NEG, sim)
        rounds += 1
    return AssignResult(row_to_col, col_to_row, rounds)
