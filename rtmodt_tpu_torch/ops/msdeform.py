"""Multi-scale deformable attention's sampling: the CUDA kernel G2's wrapper
and its plain version.

Replaces no TPU kernel: the JAX package has no RT-DETR.  Written because no
library call does this on the card (torchvision is absent and PyTorch has
no such op), and the plain version's ``grid_sample`` per level writes every
sampled value of every point to device memory before the weighted sum.

Function: value maps ``(B, V, H, D)`` (the flattened levels of ``shapes``,
level after level, rows of width ``w``), sampling locations ``(B, Q, H, L,
P, 2)`` float32 in [0, 1] of each level's width and height, attention
weights ``(B, Q, H, L, P)`` float32 -> ``(B, Q, H * D)`` in the value's
dtype: for every query and head the weighted sum over levels and points of
the bilinear sample at the location (``grid_sample``'s rule with zero
padding and ``align_corners=False``: pixel ``x = loc_x * w - 0.5``, corners
outside the level count zero), accumulated in float32.

The kernel (``csrc/msdeform_kernel.cu``) is bound by the latency of its
gathers: 64 bytes a corner, four corners a point, read from maps that
exceed the L2 cache at the cells' batch.  One warp takes one (frame, query,
head); its two half-warps take alternate points, each lane a pair of
channels (a 4-byte load of the corner's 64-byte row, coalesced across the
half-warp), all four corners' loads issued before the arithmetic; the
halves' sums meet by one shuffle.  Its least time is the bytes of one read
of the maps, locations and weights and one write of the output
(``perfbench/msdeform_bound.py``).

``msdeform_attn`` launches the kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors only; every call counts, while the span
recorder is on, ``msdeform_launches`` and ``msdeform_points`` (B x Q x H x
L x P, from the shapes).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rtmodt_tpu_torch import _build
from rtmodt_tpu_torch.profiling import spans

HEAD_DIM = 32        # the kernel's channels a head: a lane a pair of them
MAX_LEVELS = 4

# kernel launches made by msdeform_attn (reset by callers that count a run)
launches = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("msdeform_kernel").msdeform_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def msdeform_plain(value: torch.Tensor, shapes: tuple[tuple[int, int], ...],
                   loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The plain version (Ultralytics' ``multi_scale_deformable_attn_pytorch``):
    ``grid_sample`` per level in float32, then the weighted sum."""
    b, _, h, d = value.shape
    _, q, _, nl, p, _ = loc.shape
    maps = value.float().split([hh * ww for hh, ww in shapes], dim=1)
    grids = 2.0 * loc.float() - 1.0
    sampled = []
    for lvl, (hh, ww) in enumerate(shapes):
        v = maps[lvl].flatten(2).transpose(1, 2).reshape(b * h, d, hh, ww)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)            # (B*H, Q, P, 2)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))              # (B*H, D, Q, P)
    w = weights.float().transpose(1, 2).reshape(b * h, 1, q, nl * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * w).sum(-1).view(b, h * d, q)
    return out.transpose(1, 2).to(value.dtype).contiguous()


def msdeform_attn(value: torch.Tensor, shapes: tuple[tuple[int, int], ...],
                  loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Deformable sampling (module docstring): the kernel on the card, the
    plain version on the CPU."""
    global launches
    b, v, h, d = value.shape
    _, q, _, nl, p, _ = loc.shape
    spans.count("msdeform_launches")
    spans.count("msdeform_points", b * q * h * nl * p)
    if value.device.type == "cpu":
        return msdeform_plain(value, shapes, loc, weights)
    if value.device.type != "cuda":
        raise ValueError(f"msdeform_attn runs on CUDA or CPU tensors, got {value.device}")
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"value maps must be bfloat16 or float32, got {value.dtype}")
    if d != HEAD_DIM:
        raise ValueError(f"the kernel takes {HEAD_DIM} channels a head, got {d}")
    if not 1 <= nl <= MAX_LEVELS or len(shapes) != nl:
        raise ValueError(f"{len(shapes)} level shapes for {nl} levels (at most {MAX_LEVELS})")
    if sum(hh * ww for hh, ww in shapes) != v:
        raise ValueError(f"level shapes {shapes} hold {sum(a * c for a, c in shapes)} "
                         f"positions, the value maps {v}")
    if tuple(loc.shape) != (b, q, h, nl, p, 2) or tuple(weights.shape) != (b, q, h, nl, p):
        raise ValueError(f"locations {tuple(loc.shape)} / weights {tuple(weights.shape)} "
                         f"do not fit value maps {tuple(value.shape)}")
    if loc.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError("locations and weights must be float32")
    if not (loc.device == value.device == weights.device):
        raise ValueError("value maps, locations and weights must share one device")
    value, loc, weights = value.contiguous(), loc.contiguous(), weights.contiguous()
    out = torch.empty((b, q, h * d), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    hw = (ctypes.c_int * (2 * nl))(*[x for s in shapes for x in s])
    rc = _launcher()(value.data_ptr(), loc.data_ptr(), weights.data_ptr(), out.data_ptr(),
                     int(value.dtype == torch.bfloat16), b, v, q, h, nl, p, hw,
                     torch.cuda.current_stream(value.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"msdeform kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
