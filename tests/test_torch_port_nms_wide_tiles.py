"""The numpy model of the greedy-NMS kernel's wide path
(tests/test_torch_port_nms_wide.py) at its scan tile's boundaries, K = 2048.

The scan walks the compact rows in tiles of 512: these cases put v at 511,
512, 513 and 1025 compact rows (a tile short of full, full, one row into the
next, one row into the third), every row suppressed across tiles by the
first (identical boxes), none suppressed (disjoint boxes, all of the frame
and one row past the first tile), one valid row at the frame's last row,
chains of boxes each suppressing only the next (the block scan's fixpoint
then needs a round a row), and the thresholds -0.1, 0.0 and 0.9999 at 1025
rows.  The same cases run on the card in tests/test_torch_port_kernels.py.
Each is held exactly to the plain version and, where the sequential
oracle's Python loop stays short, to the oracle too.  The model's sizes are
read against the kernel source's constants, and its conflict grid is also
run with fewer blocks than pairs, so that a block loops over several.
"""

from __future__ import annotations

import os
import re

import pytest

from tests.test_torch_port_nms_wide import (
    COL_TILE_WORDS, CONF_GRID, CONF_WARPS, OR_ROWS, ROW_BLOCK, THREADS, TILE, check_wide_model)
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tools.nms_kernel_times_torch import SCAN_TILE, WIDE_EDGE_CASES, WIDE_EDGE_K

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "rtmodt_tpu_torch", "csrc", "nms_kernel.cu")


def test_the_cases_sit_on_the_kernels_tile():
    with open(KERNEL_SOURCE) as f:
        src = f.read()
    const = {name: int(value) for name, value in
             re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}
    assert const["kTile"] == SCAN_TILE == TILE
    assert const["kThreads"] == THREADS
    assert const["kRowBlock"] == ROW_BLOCK
    assert const["kConfThreads"] // 32 == CONF_WARPS
    assert const["kColTileWords"] == COL_TILE_WORDS
    assert const["kOrRows"] == OR_ROWS
    assert const["kConfGrid"] == CONF_GRID


@pytest.mark.parametrize("name,valid,t", WIDE_EDGE_CASES)
def test_wide_model_at_tile_boundaries(name, valid, t):
    # the oracle's loop costs ~5 us a pair of kept rows: the disjoint frame
    # keeps all 2048 (its check is keep == score > 0)
    oracle = not (name == "disjoint" and valid is None)
    rounds: dict[int, int] = {}
    got = check_wide_model(name, WIDE_EDGE_K, t, oracle, valid=valid, seed=11, rounds=rounds)
    if valid is not None:
        assert not got[valid:].any()
    if name == "chain":                             # chains settle a row a round
        assert max(rounds) >= 30, rounds
    if name == "random" and t == 0.45:              # sparse conflicts settle in a few rounds
        assert max(rounds) <= 4, rounds


@pytest.mark.parametrize("grid", [1, 7])
def test_wide_model_with_blocks_that_loop_over_pairs(grid):
    # v = 1025 rows: 3 column tiles in use, 96 pairs over 1 or 7 blocks
    check_wide_model("random", WIDE_EDGE_K, 0.45, oracle=False, valid=2 * SCAN_TILE + 1,
                     seed=11, grid=grid)
