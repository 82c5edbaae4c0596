"""A numpy model of the greedy-NMS CUDA kernel's algorithm, held to the oracles.

``rtmodt_tpu_torch/csrc/nms_kernel.cu`` runs in three steps: a block-wide
ballot compaction of the valid rows, conflict words of 32 columns built by
warp ballots over valid pairs only, and a serial scan in blocks of 32 rows
held in one warp's registers.  The kernel itself runs only on the card
(tests/test_torch_port_kernels.py holds it there to the plain version); this
file models the same three steps lane by lane, with the kernel's f32 IoU
arithmetic, and holds the model's keep mask exactly (booleans, no tolerance)
to the sequential oracle ``np_greedy_nms_keep`` and to the port's plain
version ``greedy_suppress_reference``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtmodt_tpu_torch.ops.nms_kernel import greedy_suppress_reference
from tests.test_pallas_kernels import np_greedy_nms_keep
from tests.test_torch_port_kernels import nms_case
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

LANES = 32
THREADS = 1024         # the kernel's CTA: one thread per candidate
UNSET = np.uint32(0xDEADBEEF)   # conflict words the kernel never writes


def _ballot(pred: np.ndarray) -> np.uint32:
    """__ballot_sync over one warp: bit l = lane l's predicate."""
    return np.uint32(sum(int(p) << lane for lane, p in enumerate(pred)))


def _popc(x) -> int:
    return bin(int(x)).count("1")


def _iou_above(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """IoU(row box a, column boxes b) > t in f32, in the kernel's order, with
    its zero-overlap case decided without the divide."""
    f32 = np.float32
    ix = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]), f32(0))
    iy = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]), f32(0))
    inter = ix * iy
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    den = ((area_a + area_b) - inter) + f32(1e-7)
    zero = (f32(t) < 0) & (den != 0) & ~np.isnan(den)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(inter == 0, zero, inter / den > f32(t))


def model_keep(boxes: np.ndarray, scores: np.ndarray, t: float) -> np.ndarray:
    k = len(scores)
    assert k <= THREADS
    keep = np.full(k, 2, np.int8)            # 2 = never written
    # 1. stage and compact: thread i takes row i, a ballot per warp
    valid = np.array([i < k and scores[i] > 0 for i in range(THREADS)])
    ballots = [_ballot(valid[w:w + LANES]) for w in range(0, THREADS, LANES)]
    counts = [_popc(b) for b in ballots]
    vi: list[int] = []
    for i in range(k):
        warp, lane = divmod(i, LANES)
        if valid[i]:
            pos = sum(counts[:warp]) + _popc(int(ballots[warp]) & ((1 << lane) - 1))
            assert pos == len(vi)                # ascending compact order
            vi.append(i)
        else:
            keep[i] = 0
    v = sum(counts)
    if v == 0:
        assert (keep == 0).all()
        return keep.astype(bool)
    sbox = boxes[vi]
    # 2. conflict words by ballot: word (a, g) for g >= a // 32 only
    words = (v + LANES - 1) // LANES
    conf = np.full((v, words), UNSET, np.uint32)
    for a in range(v):
        for g in range(a // LANES, words):
            c = g * LANES + np.arange(LANES)
            in_range = (c > a) & (c < v)
            hit = np.zeros(LANES, bool)
            hit[in_range] = _iou_above(sbox[a], sbox[c[in_range]], t)
            conf[a, g] = _ballot(hit)
    # 3. blocked scan: lane w's register `removed[w]` holds removed word w
    removed = np.zeros(LANES, np.uint32)
    for g in range(words):
        row0 = g * LANES
        n = min(LANES, v - row0)
        diag = [conf[row0 + r, g] if r < n else np.uint32(0) for r in range(LANES)]
        assert UNSET not in diag[:n]
        r_g = int(removed[g])
        for r in range(LANES):
            if not (r_g >> r) & 1:
                r_g |= int(diag[r])
        removed[g] = r_g
        kept = ~r_g & ((1 << n) - 1)
        for lane in range(g + 1, words):      # the other lanes, in parallel
            for r in range(LANES):
                if (kept >> r) & 1:
                    assert conf[row0 + r, lane] != UNSET
                    removed[lane] |= conf[row0 + r, lane]
        for lane in range(n):
            keep[vi[row0 + lane]] = (kept >> lane) & 1
    assert (keep != 2).all()                 # every row of keep is written
    return keep.astype(bool)


def scan_case(name: str, k: int, seed: int):
    """One frame of nms_case: boxes (k, 4) f32 and scores (k,) f32, sorted by
    score."""
    boxes, scores = nms_case(name, seed, b=1, k=k)
    return boxes[0].numpy(), scores[0].numpy()


KS = (1, 31, 32, 33, 64, 65, 300)
CASES = ([("random", k) for k in KS] + [("holes", k) for k in KS]
         + [(name, k) for name in ("identical", "class_offset", "no_valid", "one_valid",
                                   "degenerate")
            for k in (1, 33, 65, 300)])


@pytest.mark.parametrize("name,k", CASES)
def test_model_matches_sequential_oracle_and_plain_version(name, k):
    boxes, scores = scan_case(name, k, seed=k)
    t = 0.45
    got = model_keep(boxes, scores, t)
    np.testing.assert_array_equal(got, np_greedy_nms_keep(boxes, scores, t))
    plain = greedy_suppress_reference(torch.from_numpy(boxes)[None],
                                      torch.from_numpy(scores)[None], t)[0].numpy()
    np.testing.assert_array_equal(got, plain)
    if name == "identical":
        assert got.sum() == (scores > 0).any()
    if name in ("no_valid", "one_valid"):
        assert got.sum() == (name == "one_valid")


@pytest.mark.parametrize("name", ["random", "degenerate"])
@pytest.mark.parametrize("t", [-0.1, 0.0, 0.9999])
def test_model_at_other_thresholds(name, t):
    """t < 0 turns every non-overlapping pair into a conflict; t = 0 makes
    any overlap one."""
    boxes, scores = scan_case(name, 65, seed=3)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np_greedy_nms_keep(boxes, scores, t)
    got = model_keep(boxes, scores, t)
    np.testing.assert_array_equal(got, want)
    plain = greedy_suppress_reference(torch.from_numpy(boxes)[None],
                                      torch.from_numpy(scores)[None], t)[0].numpy()
    np.testing.assert_array_equal(got, plain)
