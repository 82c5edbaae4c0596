"""Greedy maximum-similarity assignment (port of ``rtmodt_tpu/ops/assignment.py``).

Greedy = repeatedly take the globally best (row, col) pair whose similarity
is >= threshold and retire its row and column.  It runs as parallel
mutual-best rounds: every pair that is each other's argmax (first-index tie
break) is committed at once, which reproduces sequential greedy and needs
typically 2-4 rounds, ``min(R, C)`` at worst.

``greedy_assign`` launches the CUDA kernel ``csrc/assign_kernel.cu`` for
tensors on the card (one CTA per matrix, every round on the card, no read of
the device from the host, so a tracker step that calls it can be captured in
a CUDA graph) and raises on what the kernel does not take; it takes the plain
version, ``greedy_assign_reference``, only for tensors on the CPU.  The two
give the same ``row_to_col`` and ``col_to_row`` bit for bit; on the card
``rounds`` is a 0-d int32 device tensor (``int()`` of it is the plain
version's count), on the CPU a Python int.  ``launches`` counts the kernel's
launches (a CUDA-graph replay of a captured launch does not call the wrapper
and is not counted).

The plain version's loop form: the reference's data-dependent
``lax.while_loop`` becomes a Python loop bounded at ``min(R, C)`` rounds whose
condition (any entry still >= threshold) is read on the host once per round,
for one matrix or for a stream axis of them (the reference ``vmap``s its loop
over streams).  That read is the ``sync`` span of ``profiling/spans.py``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from rtmodt_tpu_torch import _build
from rtmodt_tpu_torch.profiling.spans import span

NEG = -1e9

# kernel launches made by greedy_assign (reset by callers that count a run)
launches = 0

_fn = None


class AssignResult(NamedTuple):
    row_to_col: torch.Tensor  # (R,) or (S, R) int32, -1 if row unmatched
    col_to_row: torch.Tensor  # (C,) or (S, C) int32, -1 if col unmatched
    # mutual-best rounds taken (all streams together): a Python int on the
    # CPU, a 0-d int32 tensor on the card
    rounds: int | torch.Tensor


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("assign_kernel")
        fn = lib.assign_greedy_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
        fn.restype = ctypes.c_int
        scratch = lib.assign_scratch_bytes
        scratch.argtypes = [ctypes.c_int] * 3
        scratch.restype = ctypes.c_size_t
        _fn = (fn, scratch)
    return _fn


def greedy_assign(similarity: torch.Tensor, threshold: float,
                  row_valid: torch.Tensor | None = None,
                  col_valid: torch.Tensor | None = None) -> AssignResult:
    """Greedy assignment over a (R, C) similarity matrix, or over S streams'
    (S, R, C) matrices at once; a match requires ``similarity >=
    threshold``; invalid rows/cols (``row_valid`` (R,) / (S, R), ``col_valid``
    (C,) / (S, C)) never match; NaN entries count as -1e9 so one poisoned
    pair cannot disable the frame.  The kernel on the card, the plain
    version on the CPU (see the module docstring)."""
    if similarity.device.type == "cpu":
        return greedy_assign_reference(similarity, threshold, row_valid, col_valid)
    if similarity.device.type != "cuda":
        raise ValueError(f"unsupported device {similarity.device}")
    return _greedy_assign_cuda(similarity, threshold, row_valid, col_valid)


def _mask(valid: torch.Tensor | None, shape: tuple, device, what: str) -> torch.Tensor | None:
    if valid is None:
        return None
    if valid.dtype != torch.bool:
        raise TypeError(f"{what} must be bool, got {valid.dtype}")
    if tuple(valid.shape) != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(valid.shape)}")
    if valid.device != device:
        raise ValueError(f"{what} on {valid.device} but the similarity on {device}")
    return valid.contiguous()


def _greedy_assign_cuda(similarity, threshold, row_valid, col_valid) -> AssignResult:
    global launches
    if similarity.ndim not in (2, 3):
        raise ValueError(f"similarity must be (R, C) or (S, R, C), got "
                         f"{tuple(similarity.shape)}")
    batched = similarity.ndim == 3
    sim = similarity.float().contiguous()
    if not batched:
        sim = sim[None]
    s, r, c = sim.shape
    dev = sim.device
    lead = (s,) if batched else ()
    rv = _mask(row_valid, (*lead, r), dev, "row_valid")
    cv = _mask(col_valid, (*lead, c), dev, "col_valid")
    row_to_col = torch.full((s, r), -1, dtype=torch.int32, device=dev)
    col_to_row = torch.full((s, c), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    if s and r and c:
        fn, scratch_bytes = _launcher()
        with torch.cuda.device(dev):
            # the global path's flags and bests (none where the matrix fits
            # shared memory); freed on this stream after the launch
            nbytes = scratch_bytes(s, r, c)
            scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
                       if nbytes else None)
            err = fn(sim.data_ptr(), None if rv is None else rv.data_ptr(),
                     None if cv is None else cv.data_ptr(), row_to_col.data_ptr(),
                     col_to_row.data_ptr(), rounds.data_ptr(),
                     None if scratch is None else scratch.data_ptr(), s, r, c,
                     float(threshold), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"assign_greedy_launch failed with CUDA error {err}")
        launches += 1
    if not batched:
        row_to_col, col_to_row = row_to_col[0], col_to_row[0]
    return AssignResult(row_to_col, col_to_row, rounds)


def greedy_assign_reference(similarity: torch.Tensor, threshold: float,
                            row_valid: torch.Tensor | None = None,
                            col_valid: torch.Tensor | None = None) -> AssignResult:
    """The plain version of ``greedy_assign``, on any device.

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
        while rounds < min(r, c):
            with span("sync"):
                more = bool(sim.max() >= thr)
            if not more:
                break
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


def greedy_assign_rounds(similarity: torch.Tensor, threshold: float,
                         row_valid: torch.Tensor | None = None,
                         col_valid: torch.Tensor | None = None) -> int:
    """Mutual-best rounds until convergence (a scaling diagnostic), an int on
    either device: a thin wrapper over ``greedy_assign``, so it cannot drift
    from what the trackers run."""
    return int(greedy_assign(similarity, threshold, row_valid, col_valid).rounds)
