"""A numpy model of the greedy-NMS CUDA kernel's wide path (K > 1024), held
to the oracles.

For K above 1024 ``rtmodt_tpu_torch/csrc/nms_kernel.cu`` runs three kernels
over a scratch buffer in device memory: a compaction of the valid rows
looped over 1024-row tiles with a running offset, conflict words of 32
columns built by warp ballots (one block per 32 compact rows of a frame,
words on or right of the diagonal group only), and a blocked scan whose
removed words sit in shared memory, word w owned by thread w mod 1024.  The
kernels run only on the card (tests/test_torch_port_kernels.py holds them
there to the plain version); this file models the same steps with the
kernel's f32 IoU arithmetic and holds the model's keep mask exactly
(booleans, no tolerance) to the sequential oracle ``np_greedy_nms_keep``
and to the port's plain version ``greedy_suppress_reference``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtmodt_tpu_torch.ops.nms_kernel import greedy_suppress_reference
from tests.test_pallas_kernels import np_greedy_nms_keep
from tests.test_torch_port_kernels import nms_case
from tests.test_torch_port_nms_scan import _iou_above
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

LANES = 32
THREADS = 1024         # the compaction's and the scan's CTA
ROW_BLOCK = 32         # compact rows of one conflict block
CONF_WARPS = 8         # warps of one conflict block
UNSET = np.uint32(0xDEADBEEF)   # scratch the kernels never write
LANE_BITS = np.uint64(1) << np.arange(LANES, dtype=np.uint64)


def _ballots(hit: np.ndarray) -> np.ndarray:
    """__ballot_sync of consecutive warps: (n * 32,) bools -> (n,) u32."""
    return (hit.reshape(-1, LANES).astype(np.uint64) * LANE_BITS).sum(axis=1).astype(np.uint32)


def _popc(x) -> int:
    return bin(int(x)).count("1")


def compact(boxes: np.ndarray, scores: np.ndarray, keep: np.ndarray):
    """Step 1: tiles of 1024 rows, one thread a row; a ballot per warp and
    the warps' counts give each valid row its compact index after the
    earlier tiles' ``offset``.  Invalid rows get keep = 0."""
    k = len(scores)
    box = np.full((k, 4), np.nan, np.float32)      # scratch rows past v stay unset
    vi = np.full(k, -1)
    offset = 0
    for t0 in range(0, k, THREADS):
        i = t0 + np.arange(THREADS)
        valid = np.zeros(THREADS, bool)
        valid[i < k] = scores[i[i < k]] > 0
        ballots = _ballots(valid)
        counts = [_popc(b) for b in ballots]
        for th in np.flatnonzero(i < k):
            warp, lane = divmod(int(th), LANES)
            if valid[th]:
                pos = (offset + sum(counts[:warp])
                       + _popc(int(ballots[warp]) & ((1 << lane) - 1)))
                assert vi[pos] == -1
                box[pos], vi[pos] = boxes[i[th]], i[th]
            else:
                keep[i[th]] = 0
        offset += sum(counts)
    assert (np.diff(vi[:offset]) > 0).all()        # ascending compact order
    return box, vi, offset


def conflict_words(box: np.ndarray, v: int, k: int, t: float) -> np.ndarray:
    """Step 2: block (frame, row0) for row0 < v; warp w takes rows row0 + w,
    row0 + w + 8, ...; for each group g from a / 32 on, lane l tests column
    32 g + l, and the warp's ballot is word (a, g).  Row stride ceil(K/32)."""
    words, vwords = -(-k // LANES), -(-v // LANES)
    conf = np.full((k, words), UNSET, np.uint32)
    for row0 in range(0, -(-k // ROW_BLOCK) * ROW_BLOCK, ROW_BLOCK):
        if row0 >= v:
            continue                                # the block returns at once
        for warp in range(CONF_WARPS):
            for a in range(row0 + warp, min(row0 + ROW_BLOCK, v), CONF_WARPS):
                g0 = a // LANES
                c = np.arange(g0 * LANES, vwords * LANES)
                hit = np.zeros(len(c), bool)
                cols = (c > a) & (c < v)
                hit[cols] = _iou_above(box[a], box[c[cols]], t)
                conf[a, g0:vwords] = _ballots(hit)
    return conf


def scan(conf: np.ndarray, vi: np.ndarray, v: int, keep: np.ndarray) -> None:
    """Step 3: ``removed`` is the shared array of ceil(K/32) words, word w
    touched only by thread w mod 1024.  For block g the owner of word g
    walks the 32 diagonal words serially; after the barrier each thread ORs
    the kept rows' words into its own words right of g."""
    words, vwords = conf.shape[1], -(-v // LANES)
    removed = np.zeros(words, np.uint32)
    touched_by = np.full(words, -1)
    for g in range(vwords):
        row0 = g * LANES
        n = min(LANES, v - row0)
        owner = g % THREADS
        diag = conf[row0:row0 + n, g]
        assert UNSET not in diag
        rem = int(removed[g])
        for r in range(n):
            if not (rem >> r) & 1:
                rem |= int(diag[r])
        removed[g] = rem
        assert touched_by[g] in (-1, owner)
        touched_by[g] = owner
        kept = ~rem & ((1 << n) - 1)
        rows = row0 + np.flatnonzero([(kept >> r) & 1 for r in range(n)])
        for thread in range(min(THREADS, vwords)):
            mine = np.arange(thread, vwords, THREADS)
            mine = mine[mine > g]
            if not len(mine) or not len(rows):
                continue
            block = conf[np.ix_(rows, mine)]
            assert UNSET not in block
            removed[mine] |= np.bitwise_or.reduce(block, axis=0)
            assert np.isin(touched_by[mine], (-1, thread)).all()
            touched_by[mine] = thread
        for lane in range(n):
            keep[vi[row0 + lane]] = (kept >> lane) & 1


def wide_model_keep(boxes: np.ndarray, scores: np.ndarray, t: float) -> np.ndarray:
    k = len(scores)
    assert k > THREADS                              # the wide path's K
    keep = np.full(k, 2, np.int8)                   # 2 = never written
    box, vi, v = compact(boxes, scores, keep)
    if v:
        scan(conflict_words(box, v, k, t), vi, v, keep)
    assert (keep != 2).all()                        # every row of keep is written
    return keep.astype(bool)


# (name, threshold): K = 1025, the wide path's first K (two compaction
# tiles, the second of one row), held to both oracles in every case;
# tests/test_torch_port_nms_wide_2048.py runs K = 2048
CASES = ([(name, 0.45) for name in ("random", "holes", "class_offset", "identical",
                                    "one_valid", "no_valid", "zero_score")]
         + [("degenerate", 0.0), ("random", -0.1), ("holes", 0.9999)])


def check_wide_model(name: str, k: int, t: float, oracle: bool) -> None:
    """The model's keep mask on nms_case's scene against the plain version
    and, with ``oracle``, the sequential oracle."""
    boxes, scores = nms_case(name, seed=k, b=1, k=k)
    boxes, scores = boxes[0].numpy(), scores[0].numpy()
    got = wide_model_keep(boxes, scores, t)
    if oracle:
        with np.errstate(divide="ignore", invalid="ignore"):
            np.testing.assert_array_equal(got, np_greedy_nms_keep(boxes, scores, t))
    plain = greedy_suppress_reference(torch.from_numpy(boxes)[None],
                                      torch.from_numpy(scores)[None], t)[0].numpy()
    np.testing.assert_array_equal(got, plain)
    if name == "identical" or t < 0:
        assert got.sum() == (scores > 0).any()
    if name in ("no_valid", "one_valid"):
        assert got.sum() == (name == "one_valid")


@pytest.mark.parametrize("name,t", CASES)
def test_wide_model_matches_sequential_oracle_and_plain_version(name, t):
    check_wide_model(name, 1025, t, oracle=True)
