"""Greedy NMS suppression: the CUDA kernel's wrapper and its plain version.

Port of the TPU kernel ``rtmodt_tpu/ops/pallas/nms_kernel.py:24``
(``_nms_kernel``, reached through ``pallas_greedy_suppress``).  Function, for
a batch of B frames: boxes ``(B, K, 4)`` f32 sorted by descending score and
already class-offset, scores ``(B, K)`` -> keep ``(B, K)`` bool.  A kept,
valid row i drops every later row j with ``IoU(i, j) > iou_thresh``; rows
with score <= 0 never suppress and are never kept.

On this card the kernel is bound by latency; its roofline is bytes (5 per
candidate for its score and keep flag, 16 more per valid candidate for its
box), and the IoU tests of the valid pairs are a few MFLOP at most.
For K <= 1024 the kernel (``csrc/nms_kernel.cu``) runs one 1024-thread CTA
per frame in three steps: it compacts the valid rows (score > 0) in order
with a block-wide ballot prefix sum; builds the conflict matrix of the valid
pairs only, one u32 word of 32 columns per warp ballot; and runs greedy's
serial scan in one warp in blocks of 32 rows, where the lane that owns a
block's removed word walks the block in registers and the other lanes take
the kept rows' words in parallel.  For K > 1024 (``nms_candidates`` up to
every anchor) the same three steps run as three kernels over a scratch
buffer that this wrapper allocates (``nms_scratch_bytes``: the compact rows
and B x K x round4(ceil(K/32)) u32 conflict words, rows padded to 16 bytes;
9.07 MB a frame at K = 8400, 142.2 MB at 33600).  The compaction loops over
1024-row tiles.  The conflict words are built over the (32 compact rows,
512-column tile) pairs of the upper triangle by a grid of at most
``ceil(4096 / B)`` blocks a frame, each looping over the pairs of the column
tiles that hold the frame's valid rows (so few valid rows cost few pairs
whatever K is); a block stages a pair's columns in shared memory once and
stores each row's words with coalesced stores.
The scan walks the compact rows in tiles of 512: each tile's diagonal block
of words (32 KB) is copied into a shared double buffer two tiles ahead; one
warp scans the tile on shared memory and registers, 32 rows at a time
(each block's keep mask is the fixpoint of a warp OR-reduction, reached
in at most 33 rounds), with no block-wide barrier inside the tile;
then every thread ORs the tile's kept rows' words into the next tile's
removed words, one barrier pair a tile, and the other warps OR them into the
words past it while warp 0 scans the next tile.  Either path is one call of
``nms_greedy_launch`` and counts one launch.

``greedy_suppress`` launches the kernel for CUDA tensors (or raises) and uses
the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from rtmodt_tpu_torch import _build

IOU_EPS = 1e-7

# kernel launches made by greedy_suppress (reset by callers that count a run)
launches = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("nms_kernel")
        fn = lib.nms_greedy_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        scratch = lib.nms_scratch_bytes
        scratch.argtypes = [ctypes.c_int, ctypes.c_int]
        scratch.restype = ctypes.c_size_t
        _fn = (fn, scratch)
    return _fn


# pairs of one slab of the plain version's conflict matrix: its float
# temporaries stay near 0.5 GB whatever K is (K = 33600 is 1.1e9 pairs)
SLAB_PAIRS = 1 << 24


def pairwise_iou_batched(boxes: torch.Tensor, rows: slice = slice(None)) -> torch.Tensor:
    """(B, K, 4) xyxy -> (B, R, K) IoU of the rows ``rows`` against every box,
    element [b, i, j] = IoU(box i, box j), with the plain version's exact
    operation order."""
    a = boxes[:, rows, None, :]
    b = boxes[:, None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + IOU_EPS)


def greedy_suppress_reference(boxes: torch.Tensor, scores: torch.Tensor,
                              iou_thresh: float) -> torch.Tensor:
    """Plain PyTorch version: the batched twin of the JAX
    ``ops/nms.py::_greedy_suppress`` fixpoint, masked to valid rows.

    Sequential greedy satisfies ``keep[j] = not exists i < j: keep[i] and
    conflict[i, j]``, whose unique solution the iteration reaches in at most
    K rounds.  The (B, K, K) conflict matrix is built in slabs of rows (the
    same elementwise operations, so the same bits)."""
    b, k = scores.shape
    dev = boxes.device
    thr = torch.tensor(iou_thresh, dtype=torch.float32, device=dev)
    idx = torch.arange(k, device=dev)
    conflict = torch.empty((b, k, k), dtype=torch.bool, device=dev)
    step = max(1, SLAB_PAIRS // max(1, b * k))
    for i0 in range(0, k, step):
        rows = slice(i0, min(k, i0 + step))
        upper = idx[None, :] > idx[rows, None]
        conflict[:, rows] = (upper & (pairwise_iou_batched(boxes, rows) > thr)
                             & (scores[:, rows, None] > 0.0))
    keep = torch.ones(scores.shape, dtype=torch.bool, device=dev)
    for _ in range(k):
        new = ~torch.any(conflict & keep[:, :, None], dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep & (scores > 0.0)


def greedy_suppress(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_thresh: float) -> torch.Tensor:
    """Keep mask ``(B, K)`` bool of exact greedy NMS (see module docstring)."""
    global launches
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:2]:
        raise ValueError(f"scores must be {tuple(boxes.shape[:2])}, got "
                         f"{tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes and scores must be float32, got {boxes.dtype} "
                        f"and {scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device} but scores on {scores.device}")
    if boxes.device.type == "cpu":
        return greedy_suppress_reference(boxes, scores, iou_thresh)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must start on a 16-byte boundary (read as float4)")
    fn, scratch_bytes = _launcher()
    b, k = scores.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    # the wide path's scratch (none for K <= 1024); freed on this stream
    # after the launch, which the caching allocator orders after the kernels
    nbytes = scratch_bytes(b, k)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=boxes.device)
               if nbytes else None)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), b, k,
                 float(iou_thresh), stream)
    if err != 0:
        raise RuntimeError(f"nms_greedy_launch failed with CUDA error {err}")
    launches += 1
    return keep
