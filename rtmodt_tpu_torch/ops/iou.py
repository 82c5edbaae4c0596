"""Vectorized IoU and box-format conversions (port of ``rtmodt_tpu/ops/iou.py``)."""

from __future__ import annotations

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
