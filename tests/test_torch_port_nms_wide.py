"""A numpy model of the greedy-NMS CUDA kernel's wide path (K > 1024), held
to the oracles.

For K above 1024 ``rtmodt_tpu_torch/csrc/nms_kernel.cu`` runs three kernels
over a scratch buffer in device memory: a compaction of the valid rows
looped over 1024-row tiles with a running offset; conflict words of 32
columns built by warp ballots over the (32 compact rows, 512-column tile)
pairs of the upper triangle, on a grid of a few thousand blocks whose
blocks loop over the pairs of the column tiles that hold the v valid rows,
with a pair's columns staged in shared memory once and each row's words
stored by the lanes that keep them (rows padded to 16 bytes, words on or
right of the diagonal group only);
and a scan in tiles of 512 compact rows, whose diagonal block of words is
staged in a shared double buffer two tiles ahead, scanned by one warp on
shared memory and registers, and whose kept rows are then listed and ORed
into the next tile's removed words by every thread, and into the words past
it by the other warps during the next tile's scan.  The kernels run
only on the card (tests/test_torch_port_kernels.py holds them there to the
plain version); this file models the same steps with the kernel's f32 IoU
arithmetic, asserts that every step reads only what an earlier step wrote
or staged, and holds the model's keep mask exactly (booleans, no
tolerance) to the sequential oracle ``np_greedy_nms_keep`` and to the
port's plain version ``greedy_suppress_reference``.
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
from tools.nms_kernel_times_torch import SCAN_TILE

LANES = 32
THREADS = 1024         # the compaction's CTA
ROW_BLOCK = 32         # compact rows of one conflict block
CONF_WARPS = 8         # warps of one conflict block: rows w, w + 8, w + 16, w + 24
COL_TILE_WORDS = 16    # words of one conflict block, one a half-warp lane
COL_TILE = COL_TILE_WORDS * LANES
TILE = SCAN_TILE       # compact rows of one scan tile
TILE_WORDS = TILE // LANES
OR_ROWS = 16           # kept rows of one OR-update item
CONF_GRID = 4096       # conflict blocks of a launch, about
UNSET = np.uint32(0xDEADBEEF)   # scratch or shared memory nothing wrote
LANE_BITS = np.uint64(1) << np.arange(LANES, dtype=np.uint64)


def _ballots(hit: np.ndarray) -> np.ndarray:
    """__ballot_sync of consecutive warps: (n * 32,) bools -> (n,) u32."""
    return (hit.reshape(-1, LANES).astype(np.uint64) * LANE_BITS).sum(axis=1).astype(np.uint32)


def _popc(x) -> int:
    return bin(int(x)).count("1")


def conf_stride(k: int) -> int:
    """u32 a conflict row: ceil(K/32) rounded up to 16 bytes."""
    return (-(-k // LANES) + 3) // 4 * 4


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


def conflict_pairs(col_tiles: int) -> int:
    return COL_TILE_WORDS * col_tiles * (col_tiles + 1) // 2


def conflict_grid(b: int, k: int) -> int:
    """Blocks a frame of the conflict grid, fixed at launch before v is
    known: the pairs at K, but about CONF_GRID blocks in all."""
    col_tiles = -(-(-(-k // LANES)) // COL_TILE_WORDS)
    return min(conflict_pairs(col_tiles), -(-CONF_GRID // b))


def block_pairs(x: int, grid: int, v: int):
    """The pairs that block x of a frame takes, as the kernel decodes them:
    x, x + grid, ... below the pairs of the T = ceil(v / 512) column tiles
    that hold the v rows, in row-tile order (row tile I, the 16 row blocks
    whose diagonal words lie in column tile I, meets column tiles I .. T -
    1), with the row tile carried from one pair to the next.  Yields (row
    block i, column tile j)."""
    tiles = -(-(-(-v // LANES)) // COL_TILE_WORDS)
    row_tile = first = 0
    for p in range(x, conflict_pairs(tiles), grid):
        while p - first >= COL_TILE_WORDS * (tiles - row_tile):
            first += COL_TILE_WORDS * (tiles - row_tile)
            row_tile += 1
        yield (row_tile * COL_TILE_WORDS + (p - first) % COL_TILE_WORDS,
               row_tile + (p - first) // COL_TILE_WORDS)


def conflict_words(box: np.ndarray, v: int, k: int, t: float, grid: int | None = None):
    """Step 2: block x of the frame's ``grid`` (the kernel's at B = 1 unless
    given) takes the pairs block_pairs yields; a pair whose rows start past
    v or whose tile starts past ceil(v/32) words is skipped.  For a pair
    (row block i, column tile j) the block stages its valid columns once;
    warp w ballots each column group against its rows w, w + 8, w + 16,
    w + 24 of the block; lane l keeps word 16 j + l % 16 of rows 2 p + l //
    16, so store p writes two rows' words of the tile."""
    words = -(-k // LANES)
    vwords = -(-v // LANES)
    col_tiles = -(-words // COL_TILE_WORDS)
    vtiles = -(-vwords // COL_TILE_WORDS)
    grid = conflict_grid(1, k) if grid is None else grid
    conf = np.full((k, conf_stride(k)), UNSET, np.uint32)
    seen = set()
    for x in range(grid):
        for i, j in block_pairs(x, grid, v):
            assert (i, j) not in seen and i // COL_TILE_WORDS <= j < col_tiles
            seen.add((i, j))
            row0 = i * ROW_BLOCK
            g0 = j * COL_TILE_WORDS
            g_begin, g_end = max(i, g0), min(g0 + COL_TILE_WORDS, vwords)
            if row0 >= v or g_begin >= g_end:
                continue                            # the block skips the pair
            c_tile = g0 * LANES
            lo, hi = (g_begin - g0) * LANES, min(COL_TILE, v - c_tile)
            staged = np.full((COL_TILE, 4), np.nan, np.float32)
            staged[lo:hi] = box[c_tile + lo:c_tile + hi]
            c = np.arange(g_begin * LANES, g_end * LANES)
            for warp in range(CONF_WARPS):
                rows = row0 + warp + CONF_WARPS * np.arange(ROW_BLOCK // CONF_WARPS)
                for store in range(len(rows) // 2):
                    for a in rows[2 * store:2 * store + 2]:
                        if a >= v:
                            continue                # its words are not stored
                        tested = (c < v) & (c > a)
                        cols = staged[c[tested] - c_tile]
                        assert not np.isnan(cols).any()     # only staged columns are read
                        hit = np.zeros(len(c), bool)
                        hit[tested] = _iou_above(box[a], cols, t)
                        assert (conf[a, g_begin:g_end] == UNSET).all()   # written once
                        conf[a, g_begin:g_end] = _ballots(hit)
    assert len(seen) == conflict_pairs(vtiles)
    for a in range(v):                              # the words on or right of the diagonal
        assert UNSET not in conf[a, a // LANES:vwords]
    return conf


def stage_tile(buf: np.ndarray, conf: np.ndarray, v: int, s: int) -> None:
    """Tile s's diagonal block of words into ``buf``: rows < v, 16-byte
    chunks starting below ceil(v/32).  Whatever the buffer held before is
    marked unset, so that a read of it fails."""
    vwords = -(-v // LANES)
    r0, w0 = s * TILE, s * TILE_WORDS
    rows = min(TILE, v - r0)
    buf[:] = UNSET
    for q in range(0, TILE_WORDS, 4):
        if w0 + q < vwords:
            buf[:rows, q:q + 4] = conf[r0:r0 + rows, w0 + q:w0 + q + 4]


def block_keep(cand: int, rw: list[int], n: int) -> tuple[int, int]:
    """Warp 0's keep mask of one 32-row block: lane r holds row r's diagonal
    word ``rw[r]``; kept = cand & ~(OR of the kept rows' words), iterated
    from kept = cand (__reduce_or_sync a round) to its fixpoint, which is
    greedy's keep mask: a row only suppresses later rows, so round m
    settles row m - 1 and the fixpoint comes after n + 1 rounds at most.
    Returns (kept, rounds)."""
    kept, rounds = cand, 0
    while True:
        rounds += 1
        assert rounds <= n + 1
        hit = 0
        for lane in range(LANES):
            if (kept >> lane) & 1:
                hit |= rw[lane]
        nxt = cand & ~hit
        if nxt == kept:
            return kept, rounds
        kept = nxt


def or_kept_rows(removed: np.ndarray, conf: np.ndarray, vwords: int, rows: list[int],
                 c_begin: int, c_end: int) -> None:
    """OR the words of kept ``rows`` at 16-byte chunks c_begin .. c_end - 1
    into ``removed``: items (chunk, group of 16 rows), chunks fastest."""
    chunks = c_end - c_begin
    if not rows or chunks <= 0:
        return
    groups = -(-len(rows) // OR_ROWS)
    items = np.arange(chunks * groups)
    assert len({(int(x) % chunks, int(x) // chunks) for x in items}) == chunks * groups
    cols = np.arange(4 * c_begin, 4 * c_end)
    for gi in range(groups):
        words = conf[np.ix_(rows[gi * OR_ROWS:(gi + 1) * OR_ROWS], cols)]
        assert UNSET not in words[:, :vwords - 4 * c_begin]   # padding words are never read
        removed[cols] |= np.bitwise_or.reduce(words, axis=0)


def scan(conf: np.ndarray, vi: np.ndarray, v: int, keep: np.ndarray) -> dict:
    """Step 3: tiles of 512 compact rows.  Warp 0's lane l owns removed word
    16 s + l; for block b, the block's candidates are the rows not yet
    removed (lane b's word, shuffled), block_keep gives its keep mask from
    the staged diagonal words, and lanes right of b OR the kept rows' words
    of the staged tile; then warp 0 lists the tile's kept rows.  Meanwhile
    the other warps write the previous tile's keep bytes and OR its kept
    rows' words into the words past this tile (modelled after warp 0 has
    read this tile's words, so a write into them would be lost, as on the
    card).  After the barrier, every thread ORs the tile's kept rows' words
    into the next tile's words.  Returns how many blocks took each number of
    rounds."""
    stride = conf.shape[1]
    vwords = -(-v // LANES)
    tiles = -(-v // TILE)
    c_end = -(-vwords // 4)
    removed = np.zeros(stride, np.uint32)
    bufs = [np.full((TILE, TILE_WORDS), UNSET, np.uint32) for _ in range(2)]
    rounds: dict[int, int] = {}
    stage_tile(bufs[0], conf, v, 0)
    if tiles > 1:
        stage_tile(bufs[1], conf, v, 1)
    last: tuple[list[int], list[int]] | None = None   # the previous tile's kept rows, masks
    for s in range(tiles):
        r0 = s * TILE
        rows = min(TILE, v - r0)
        tile = bufs[s & 1]
        blocks = -(-rows // LANES)
        rem = [int(removed[s * TILE_WORDS + lane]) if lane < blocks else 0
               for lane in range(LANES)]
        if last is not None:                        # the other warps, during this scan
            klist_p, mine_p = last
            for t_ in range(TILE):
                keep[vi[r0 - TILE + t_]] = (mine_p[t_ >> 5] >> (t_ & 31)) & 1
            or_kept_rows(removed, conf, vwords, klist_p, (s + 1) * TILE_WORDS // 4, c_end)
        mine = [0] * LANES
        for b in range(blocks):
            n = min(LANES, rows - LANES * b)
            rw = [int(tile[LANES * b + r, b]) if r < n else 0 for r in range(LANES)]
            assert UNSET not in rw
            cand = ~rem[b] & ((1 << n) - 1)
            kept, used = block_keep(cand, rw, n)
            rounds[used] = rounds.get(used, 0) + 1
            mine[b] = kept
            rows_kept = LANES * b + np.flatnonzero([(kept >> r) & 1 for r in range(LANES)])
            if len(rows_kept) and b + 1 < blocks:
                words = tile[np.ix_(rows_kept, np.arange(b + 1, blocks))]
                assert UNSET not in words
                for lane, w in zip(range(b + 1, blocks), np.bitwise_or.reduce(words, axis=0)):
                    rem[lane] |= int(w)
        klist = [r0 + LANES * lane + bit for lane in range(LANES) for bit in range(LANES)
                 if (mine[lane] >> bit) & 1]
        if s + 2 < tiles:
            stage_tile(bufs[s & 1], conf, v, s + 2)
        or_kept_rows(removed, conf, vwords, klist, (s + 1) * TILE_WORDS // 4,
                     min((s + 2) * TILE_WORDS // 4, c_end))
        last = klist, mine
    r0 = (tiles - 1) * TILE                         # the last tile's keep bytes
    for t_ in range(v - r0):
        keep[vi[r0 + t_]] = (last[1][t_ >> 5] >> (t_ & 31)) & 1
    return rounds


def wide_model_keep(boxes: np.ndarray, scores: np.ndarray, t: float,
                    rounds: dict | None = None, grid: int | None = None) -> np.ndarray:
    """The model's keep mask; ``rounds`` collects the scan blocks' rounds,
    ``grid`` sets the conflict blocks of the frame."""
    k = len(scores)
    assert k > THREADS                              # the wide path's K
    keep = np.full(k, 2, np.int8)                   # 2 = never written
    box, vi, v = compact(boxes, scores, keep)
    if v:
        used = scan(conflict_words(box, v, k, t, grid), vi, v, keep)
        if rounds is not None:
            rounds.update(used)
    assert (keep != 2).all()                        # every row of keep is written
    return keep.astype(bool)


# (name, threshold): K = 1025, the wide path's first K (two compaction
# tiles, the second of one row), held to both oracles in every case;
# tests/test_torch_port_nms_wide_2048.py runs K = 2048
CASES = ([(name, 0.45) for name in ("random", "holes", "class_offset", "identical",
                                    "one_valid", "no_valid", "zero_score")]
         + [("degenerate", 0.0), ("random", -0.1), ("holes", 0.9999)])


def check_wide_model(name: str, k: int, t: float, oracle: bool, valid: int | None = None,
                     seed: int | None = None, rounds: dict | None = None,
                     grid: int | None = None) -> np.ndarray:
    """The model's keep mask on nms_case's scene against the plain version
    and, with ``oracle``, the sequential oracle (on the valid rows only where
    ``valid`` cuts the frame to a prefix: rows past it score 0, so they
    neither suppress nor are kept)."""
    boxes, scores = nms_case(name, seed=k if seed is None else seed, b=1, k=k, valid=valid)
    boxes, scores = boxes[0].numpy(), scores[0].numpy()
    got = wide_model_keep(boxes, scores, t, rounds, grid)
    if oracle:
        n = k if valid is None else valid
        want = np.zeros(k, bool)
        with np.errstate(divide="ignore", invalid="ignore"):
            want[:n] = np_greedy_nms_keep(boxes[:n], scores[:n], t)
        np.testing.assert_array_equal(got, want)
    plain = greedy_suppress_reference(torch.from_numpy(boxes)[None],
                                      torch.from_numpy(scores)[None], t)[0].numpy()
    np.testing.assert_array_equal(got, plain)
    if name == "identical" or t < 0:
        assert got.sum() == (scores > 0).any()
    if name in ("no_valid", "one_valid", "one_late"):
        assert got.sum() == (name != "no_valid")
    if name == "disjoint" and t >= 0:
        np.testing.assert_array_equal(got, scores > 0)
    if name == "chain":                             # every other box of a chain survives
        np.testing.assert_array_equal(got, (scores > 0) & (np.arange(k) % 200 % 2 == 0))
    return got


@pytest.mark.parametrize("name,t", CASES)
def test_wide_model_matches_sequential_oracle_and_plain_version(name, t):
    check_wide_model(name, 1025, t, oracle=True)
