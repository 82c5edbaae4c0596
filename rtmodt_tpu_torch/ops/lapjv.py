"""Optimal linear assignment on the host: the port's C++ Jonker-Volgenant
solver (``csrc/lapjv.cpp``, built by ``_build.py`` with the host compiler and
loaded with ctypes).  A failed build raises; there is no scipy fallback."""

from __future__ import annotations

import ctypes

import numpy as np

_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from rtmodt_tpu_torch import _build

        lib = _build.load("lapjv")
        lib.lapjv_solve.restype = ctypes.c_double
        lib.lapjv_solve.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_double,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
    return _lib


def lapjv(cost: np.ndarray, cost_limit: float = np.inf) -> np.ndarray:
    """Min-cost assignment of an (R, C) cost matrix; returns row -> col
    (int32, -1 = unassigned).  ``lap.lapjv(cost, extend_cost=True,
    cost_limit=...)`` semantics: rectangular matrices are padded, and an
    assignment costing more than ``cost_limit`` is refused."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    r, c = cost.shape
    if r == 0 or c == 0:
        return np.full(r, -1, np.int32)
    row_to_col = np.empty(r, np.int32)
    col_to_row = np.empty(c, np.int32)
    _load().lapjv_solve(r, c, cost, float(cost_limit), row_to_col, col_to_row)
    return row_to_col
