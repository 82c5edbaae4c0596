"""Greedy maximum-similarity assignment (port of ``rtmodt_tpu/ops/assignment.py``).

Greedy = repeatedly take the globally best (row, col) pair whose similarity
is >= threshold and retire its row and column.  It runs as parallel
mutual-best rounds: every pair that is each other's argmax (first-index tie
break) is committed at once, which reproduces sequential greedy and needs
typically 2-4 rounds, ``min(R, C)`` at worst.

Loop form: the reference's data-dependent ``lax.while_loop`` becomes a Python
loop bounded at ``min(R, C)`` rounds whose condition (any entry still >=
threshold) is read on the host once per round, for one matrix or for a
stream axis of them (the reference ``vmap``s its loop over streams).  On the card that read is one
device -> host sync per round; fixed ``min(R, C)`` rounds would instead
launch ~100 rounds of kernels per association at the default 256 slots x 100
detections.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1e9


class AssignResult(NamedTuple):
    row_to_col: torch.Tensor  # (R,) or (S, R) int32, -1 if row unmatched
    col_to_row: torch.Tensor  # (C,) or (S, C) int32, -1 if col unmatched
    rounds: int               # mutual-best rounds taken (all streams together)


def greedy_assign(similarity: torch.Tensor, threshold: float,
                  row_valid: torch.Tensor | None = None,
                  col_valid: torch.Tensor | None = None) -> AssignResult:
    """Greedy assignment over a (R, C) similarity matrix, or over S streams'
    (S, R, C) matrices at once; a match requires ``similarity >=
    threshold``; invalid rows/cols (``row_valid`` (R,) / (S, R), ``col_valid``
    (C,) / (S, C)) never match; NaN entries count as -1e9 so one poisoned
    pair cannot disable the frame.

    Streams: a round on a stream with no pair >= threshold left changes
    nothing there, so one loop runs until no stream has a pair left (at
    most ``min(R, C)`` rounds) and is exact for every stream; it reads one
    host condition per round for all of them."""
    batched = similarity.ndim == 3
    sim = torch.nan_to_num(similarity.float(), nan=NEG)
    if not batched:
        sim = sim[None]
        row_valid = None if row_valid is None else row_valid[None]
        col_valid = None if col_valid is None else col_valid[None]
    s, r, c = sim.shape
    dev = sim.device
    if row_valid is not None:
        sim = torch.where(row_valid[:, :, None], sim, NEG)
    if col_valid is not None:
        sim = torch.where(col_valid[:, None, :], sim, NEG)
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    row_to_col = torch.full((s, r), -1, dtype=torch.int32, device=dev)
    col_to_row = torch.full((s, c), -1, dtype=torch.int32, device=dev)
    rounds = 0
    if r and c:
        rows = torch.arange(r, dtype=torch.int32, device=dev).expand(s, r)
        sink = torch.full((s, 1), -1, dtype=torch.int32, device=dev)
        while rounds < min(r, c) and bool(sim.max() >= thr):
            row_val, row_best = sim.max(dim=2)
            col_best = sim.argmax(dim=1)
            mutual = (col_best.gather(1, row_best) == rows) & (row_val >= thr)
            row_to_col = torch.where(mutual, row_best.int(), row_to_col)
            # rows that are not mutual scatter into a sink column c, dropped
            # after (mutual pairs have distinct columns); no host sync
            tgt = torch.where(mutual, row_best, c)
            col_to_row = torch.cat([col_to_row, sink], dim=1).scatter(1, tgt, rows)[:, :c]
            col_gone = torch.zeros((s, c + 1), dtype=torch.bool, device=dev).scatter(
                1, tgt, True)[:, :c]
            sim = torch.where(mutual[:, :, None] | col_gone[:, None, :], NEG, sim)
            rounds += 1
    if not batched:
        row_to_col, col_to_row = row_to_col[0], col_to_row[0]
    return AssignResult(row_to_col, col_to_row, rounds)
