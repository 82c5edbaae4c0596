"""Vectorized IoU, complete IoU and box-format conversions (port of
``rtmodt_tpu/ops/iou.py``)."""

from __future__ import annotations

import math

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of two aligned (broadcastable) sets of xyxy boxes (..., 4) -> (...)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + eps)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU matrix between (..., M, 4) and (..., N, 4) xyxy boxes ->
    (..., M, N) (leading axes broadcast: one matrix per stream)."""
    return box_iou(a[..., :, None, :], b[..., None, :, :], eps=eps)


def ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU of aligned xyxy boxes (..., 4) -> (...), the YOLOv8 box
    loss's term.  As in the reference, the gradient flows through the aspect
    term's ``alpha`` too (ultralytics computes ``alpha`` without gradient)."""
    iou = box_iou(a, b, eps)
    c_lt = torch.minimum(a[..., :2], b[..., :2])            # enclosing box
    c_rb = torch.maximum(a[..., 2:], b[..., 2:])
    c_wh = (c_rb - c_lt).clamp(min=0.0)
    c2 = c_wh[..., 0] ** 2 + c_wh[..., 1] ** 2 + eps
    ac = (a[..., :2] + a[..., 2:]) * 0.5                    # center distance
    bc = (b[..., :2] + b[..., 2:]) * 0.5
    rho2 = torch.sum((ac - bc) ** 2, dim=-1)
    aw = a[..., 2] - a[..., 0]
    ah = a[..., 3] - a[..., 1]
    bw = b[..., 2] - b[..., 0]
    bh = b[..., 3] - b[..., 1]
    v = (4.0 / math.pi ** 2) * (torch.atan(bw / (bh + eps)) - torch.atan(aw / (ah + eps))) ** 2
    alpha = v / (v - iou + 1.0 + eps)
    return iou - rho2 / c2 - alpha * v


def xyxy_to_cxcyah(xyxy: torch.Tensor) -> torch.Tensor:
    """xyxy -> (center_x, center_y, aspect=w/h, height), the Kalman measurement space."""
    w = xyxy[..., 2] - xyxy[..., 0]
    h = xyxy[..., 3] - xyxy[..., 1]
    cx = xyxy[..., 0] + 0.5 * w
    cy = xyxy[..., 1] + 0.5 * h
    return torch.stack([cx, cy, w / h.clamp(min=1e-6), h], dim=-1)


def cxcyah_to_xyxy(m: torch.Tensor) -> torch.Tensor:
    h = m[..., 3]
    w = m[..., 2] * h
    x1 = m[..., 0] - 0.5 * w
    y1 = m[..., 1] - 0.5 * h
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=-1)
