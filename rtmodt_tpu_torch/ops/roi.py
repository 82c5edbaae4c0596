"""Batched ROI crop-and-resize (port of ``rtmodt_tpu/ops/roi.py``).

Every box of a frame is sampled in one bilinear gather into a fixed
``(D, crop_h, crop_w, C)`` patch batch for the appearance embedder.  Plain
torch: the reference runs these as XLA gathers, not as a TPU kernel.
Degenerate boxes (padded, invalid detections) sample a clamped pixel; they
are masked downstream.
"""

from __future__ import annotations

import torch


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    crop_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear crop + resize of every box of an (H, W, C) image ->
    (D, h, w, C) float32; or of a batch, (B, H, W, C) images with (B, D, 4)
    boxes -> (B, D, h, w, C) in one gather.  align_corners=False: output
    pixel i samples ``lo + (i + 0.5) * extent / out - 0.5``, corner indices
    clamped to the image; the reference's order of operations."""
    batched = image.ndim == 4
    if not batched:
        image, boxes = image[None], boxes[None]
    h_img, w_img = image.shape[1], image.shape[2]
    oh, ow = crop_hw
    img = image.float()
    b = boxes.float()
    dev = img.device
    x1, y1, x2, y2 = b[..., 0:1], b[..., 1:2], b[..., 2:3], b[..., 3:4]   # (B, D, 1)
    ys = y1 + (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * (y2 - y1) / oh - 0.5
    xs = x1 + (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * (x2 - x1) / ow - 0.5
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., :, None, None]                                     # (B, D, oh, 1, 1)
    wx = (xs - x0)[..., None, :, None]                                     # (B, D, 1, ow, 1)
    y0i = y0.to(torch.int64).clamp(0, h_img - 1)
    y1i = (y0i + 1).clamp(0, h_img - 1)
    x0i = x0.to(torch.int64).clamp(0, w_img - 1)
    x1i = (x0i + 1).clamp(0, w_img - 1)
    bi = torch.arange(img.shape[0], device=dev)[:, None, None, None]       # (B, 1, 1, 1)
    rows0, rows1 = y0i[..., :, None], y1i[..., :, None]                    # (B, D, oh, 1)
    cols0, cols1 = x0i[..., None, :], x1i[..., None, :]                    # (B, D, 1, ow)
    tl = img[bi, rows0, cols0]                                             # (B, D, oh, ow, C)
    tr = img[bi, rows0, cols1]
    bl = img[bi, rows1, cols0]
    br = img[bi, rows1, cols1]
    top = tl + (tr - tl) * wx
    bot = bl + (br - bl) * wx
    out = top + (bot - top) * wy
    return out if batched else out[0]


def crop_yuv_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, boxes: torch.Tensor,
                 crop_hw: tuple[int, int]) -> torch.Tensor:
    """ROI crops straight from planar I420 -> (D, h, w, 3) RGB in [0, 255]
    (or a batch: (B, H, W) planes with (B, D, 4) boxes -> (B, D, h, w, 3)):
    luma crops at the boxes, chroma crops at half the coordinates (the
    bilinear resize doubles as the 2x chroma upsample), then full-range
    BT.601 per crop pixel.  ``boxes`` are in luma-plane coordinates."""
    cy = crop_and_resize(y[..., None], boxes, crop_hw)[..., 0]
    cu = crop_and_resize(u[..., None], boxes * 0.5, crop_hw)[..., 0] - 128.0
    cv = crop_and_resize(v[..., None], boxes * 0.5, crop_hw)[..., 0] - 128.0
    r = cy + 1.403 * cv
    g = cy - 0.344 * cu - 0.714 * cv
    b = cy + 1.773 * cu
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)
