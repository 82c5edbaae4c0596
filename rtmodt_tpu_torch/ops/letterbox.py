"""Letterbox geometry and the BGR letterbox of the per-frame paths.

The port's copy of ``rtmodt_tpu/ops/letterbox.py``.  Geometry matches
ultralytics' LetterBox: scale ``r = min(S/h, S/w)``, content
``(round(h*r), round(w*r))``, pads split as ``round(d - 0.1)``.

``letterbox`` keeps the reference's order of operations: cast to the output
dtype, BGR -> RGB, half-pixel bilinear resize without antialias (what
``cv2.INTER_LINEAR`` does), pad with 114, then x 1/255 in the output dtype.
Plain torch: the reference computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class LetterboxMeta(NamedTuple):
    """Static geometry of one letterbox transform (Python floats/ints)."""

    scale: float
    pad_left: int
    pad_top: int
    new_w: int
    new_h: int
    src_w: int
    src_h: int


def letterbox_meta(src_h: int, src_w: int, size: int) -> LetterboxMeta:
    r = min(size / src_h, size / src_w)
    new_w, new_h = round(src_w * r), round(src_h * r)
    dw, dh = (size - new_w) / 2.0, (size - new_h) / 2.0
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    return LetterboxMeta(r, left, top, new_w, new_h, src_w, src_h)


def letterbox(frame_u8: torch.Tensor, size: int, dtype: torch.dtype = torch.bfloat16
              ) -> tuple[torch.Tensor, LetterboxMeta]:
    """uint8 BGR ``(H, W, 3)`` frame -> normalized RGB ``(size, size, 3)``
    tensor (channels last, contiguous, padded with 114) + its geometry; or a
    batch of frames ``(B, H, W, 3)`` -> ``(B, size, size, 3)``."""
    batched = frame_u8.ndim == 4
    h, w = int(frame_u8.shape[-3]), int(frame_u8.shape[-2])
    meta = letterbox_meta(h, w, size)
    x = frame_u8.to(dtype).flip(-1)
    x = x.permute(0, 3, 1, 2) if batched else x.permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(meta.new_h, meta.new_w),
                      mode="bilinear", align_corners=False, antialias=False)
    pad_bottom = size - meta.new_h - meta.pad_top
    pad_right = size - meta.new_w - meta.pad_left
    x = F.pad(x, (meta.pad_left, pad_right, meta.pad_top, pad_bottom), value=114.0)
    x = x * torch.tensor(1.0 / 255.0, dtype=dtype, device=x.device)
    x = x.permute(0, 2, 3, 1).contiguous()
    return (x if batched else x[0]), meta


def unletterbox_boxes(boxes_xyxy: torch.Tensor, meta: LetterboxMeta) -> torch.Tensor:
    """Map xyxy boxes from model (letterboxed) coordinates back to the source
    frame, clipped to it."""
    dt, dev = boxes_xyxy.dtype, boxes_xyxy.device
    shift = torch.tensor([meta.pad_left, meta.pad_top, meta.pad_left, meta.pad_top],
                         dtype=dt, device=dev)
    out = (boxes_xyxy - shift) / torch.tensor(meta.scale, dtype=dt, device=dev)
    lim = torch.tensor([meta.src_w, meta.src_h, meta.src_w, meta.src_h], dtype=dt, device=dev)
    return torch.minimum(out.clamp(min=0.0), lim)
