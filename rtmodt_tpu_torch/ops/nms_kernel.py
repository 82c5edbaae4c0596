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
The kernel (``csrc/nms_kernel.cu``) runs one 1024-thread CTA per frame in
three steps: it compacts the valid rows (score > 0) in order with a
block-wide ballot prefix sum; builds the conflict matrix of the valid pairs
only, one u32 word of 32 columns per warp ballot; and runs greedy's serial
scan in one warp in blocks of 32 rows, where the lane that owns a block's
removed word walks the block in registers and the other lanes take the kept
rows' words in parallel.

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
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.nms_max_candidates.restype = ctypes.c_int
        _fn = (fn, int(lib.nms_max_candidates()))
    return _fn


def pairwise_iou_batched(boxes: torch.Tensor) -> torch.Tensor:
    """(B, K, 4) xyxy -> (B, K, K) IoU, element [b, i, j] = IoU(box i, box j),
    with the plain version's exact operation order."""
    a = boxes[:, :, None, :]
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
    K rounds."""
    k = boxes.shape[1]
    iou = pairwise_iou_batched(boxes)
    thr = torch.tensor(iou_thresh, dtype=torch.float32, device=boxes.device)
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    conflict = upper & (iou > thr) & (scores[:, :, None] > 0.0)
    keep = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
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
    fn, max_k = _launcher()
    b, k = scores.shape
    if k > max_k:
        raise ValueError(f"K={k} candidates exceeds the kernel's {max_k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), b, k,
                 float(iou_thresh), stream)
    if err != 0:
        raise RuntimeError(f"nms_greedy_launch failed with CUDA error {err}")
    launches += 1
    return keep
