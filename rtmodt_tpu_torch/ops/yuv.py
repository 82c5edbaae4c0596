"""Packed planar I420 transport: host pack (numpy) and device unpack (torch).

Port of ``rtmodt_tpu/ops/yuv.py``.  The host resizes each BGR frame to the
letterbox content size and converts it to planar Y/U/V (12 bits/px, 7.5x
fewer bytes than 720p BGR); the device upsamples chroma, converts BT.601 to
RGB, normalises and pads to the model input in ``planar_letterbox``.

``pack_chunk`` dispatches as the reference does: the port's native packer
(``ops/framepack.py``, C++ built on first use) on the exact integer
downsamples where it is fastest (720p -> 640x360 is 2x, 1080p -> 640x360 is
3x), cv2's bilinear resize and I420 conversion on every other geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from rtmodt_tpu_torch.ops.framepack import Planes, native_pack_wins, pack_i420_chunk_native
from rtmodt_tpu_torch.ops.letterbox import LetterboxMeta, letterbox_meta


def content_dims(src_h: int, src_w: int, size: int) -> tuple[int, int]:
    """Letterbox content (h, w) rounded to even (I420 needs even dims)."""
    m = letterbox_meta(src_h, src_w, size)
    return (m.new_h // 2) * 2, (m.new_w // 2) * 2


def packed_meta(src_h: int, src_w: int, size: int) -> LetterboxMeta:
    """LetterboxMeta of the packed-I420 geometry: content dims rounded to
    even and pads rounded DOWN to even so the half-res chroma grid stays
    aligned."""
    ch, cw = content_dims(src_h, src_w, size)
    scale = min(ch / src_h, cw / src_w)
    pad_left = (int(round((size - cw) / 2 - 0.1)) // 2) * 2
    pad_top = (int(round((size - ch) / 2 - 0.1)) // 2) * 2
    return LetterboxMeta(scale, pad_left, pad_top, cw, ch, src_w, src_h)


def unletterbox_boxes_packed(boxes_xyxy: torch.Tensor,
                             meta: LetterboxMeta) -> torch.Tensor:
    """Inverse of the packed geometry: each axis is divided by its realized
    scale (new/src), then boxes are clipped to the source frame."""
    dt, dev = boxes_xyxy.dtype, boxes_xyxy.device
    shift = torch.tensor([meta.pad_left, meta.pad_top, meta.pad_left, meta.pad_top],
                         dtype=dt, device=dev)
    sx = meta.new_w / meta.src_w
    sy = meta.new_h / meta.src_h
    scale = torch.tensor([sx, sy, sx, sy], dtype=dt, device=dev)
    out = (boxes_xyxy - shift) / scale
    lim = torch.tensor([meta.src_w, meta.src_h, meta.src_w, meta.src_h],
                       dtype=dt, device=dev)
    return torch.minimum(out.clamp(min=0.0), lim)


def _up2(p: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of the last two axes."""
    *lead, h, w = p.shape
    return p[..., :, None, :, None].expand(*lead, h, 2, w, 2).reshape(*lead, 2 * h, 2 * w)


def planar_letterbox(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     size: int, pad_left: int, pad_top: int,
                     dtype: torch.dtype = torch.bfloat16,
                     pad_value: float = 114.0) -> torch.Tensor:
    """Planar I420 ``y (..., ch, cw)``, ``u, v (..., ch/2, cw/2)`` uint8 ->
    padded normalized RGB ``(..., size, size, 3)`` (channels last).

    Nearest 2x chroma upsample, full-range BT.601 (1.403 / 0.344 / 0.714 /
    1.773), /255, clip to [0, 1], pad of 114/255; all arithmetic in ``dtype``
    with constants rounded to ``dtype``, as the reference does."""
    ch, cw = y.shape[-2:]
    dev = y.device

    def c(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=dtype, device=dev)

    yf = y.to(dtype)
    uf = _up2(u.to(dtype) - c(128.0))
    vf = _up2(v.to(dtype) - c(128.0))
    scale = c(1.0 / 255.0)
    r = (yf + c(1.403) * vf) * scale
    g = (yf - c(0.344) * uf - c(0.714) * vf) * scale
    b = (yf + c(1.773) * uf) * scale
    rgb = torch.stack([r, g, b], dim=-1).clamp(0.0, 1.0)
    out = torch.full((*y.shape[:-2], size, size, 3), pad_value / 255.0,
                     dtype=dtype, device=dev)
    out[..., pad_top:pad_top + ch, pad_left:pad_left + cw, :] = rgb
    return out


def pad_planes(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, size: int,
               pad_left: int, pad_top: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Letterbox-pad content planes ``(..., ch, cw)`` / ``(..., ch/2, cw/2)``
    to the model grid: Y with 114, chroma with 128 (the reference's
    ``ops/planar_stem.py::pad_planes``; pads are even)."""
    ch, cw = y.shape[-2:]

    def pad(p: torch.Tensor, n: int, top: int, left: int, value: int) -> torch.Tensor:
        out = torch.full((*p.shape[:-2], n, n), value, dtype=p.dtype, device=p.device)
        out[..., top:top + p.shape[-2], left:left + p.shape[-1]] = p
        return out

    return (pad(y, size, pad_top, pad_left, 114),
            pad(u, size // 2, pad_top // 2, pad_left // 2, 128),
            pad(v, size // 2, pad_top // 2, pad_left // 2, 128))


def _pack_cv2(frames: np.ndarray, out: Planes) -> None:
    import cv2

    y, u, v = out
    ch, cw = y.shape[1:]
    n_chroma = (ch // 2) * (cw // 2)
    for i in range(frames.shape[0]):
        resized = cv2.resize(frames[i], (cw, ch), interpolation=cv2.INTER_LINEAR)
        yuv = cv2.cvtColor(resized, cv2.COLOR_BGR2YUV_I420)
        y[i] = yuv[:ch]
        chroma = yuv[ch:].reshape(-1)
        u[i] = chroma[:n_chroma].reshape(ch // 2, cw // 2)
        v[i] = chroma[n_chroma:2 * n_chroma].reshape(ch // 2, cw // 2)


def pack_chunk(frames_bgr: np.ndarray, size: int,
               out: Planes | None = None) -> tuple[Planes, LetterboxMeta]:
    """Pack a (N, H, W, 3) uint8 BGR chunk into planar I420 content planes
    ``(y (N, ch, cw), u (N, ch/2, cw/2), v)``, written into ``out`` when
    given (C-contiguous uint8).  Returns (planes, packed geometry).

    Dispatch as the reference's: the native packer where its fast paths
    apply (``ops/framepack.py::native_pack_wins``: odd integer factors, and
    2x with a content width that is a multiple of 32), cv2 resize +
    ``COLOR_BGR2YUV_I420`` everywhere else."""
    n, h, w = frames_bgr.shape[:3]
    ch, cw = content_dims(h, w, size)
    if native_pack_wins(h, w, ch, cw):
        return pack_i420_chunk_native(frames_bgr, ch, cw, out=out), packed_meta(h, w, size)
    if out is None:
        out = (np.empty((n, ch, cw), np.uint8),
               np.empty((n, ch // 2, cw // 2), np.uint8),
               np.empty((n, ch // 2, cw // 2), np.uint8))
    _pack_cv2(frames_bgr, out)
    return out, packed_meta(h, w, size)


def pack_i420_planar(frame_bgr: np.ndarray, size: int) -> tuple[Planes, LetterboxMeta]:
    """One (H, W, 3) BGR frame -> ((y (ch, cw), u (ch/2, cw/2), v), packed
    geometry), through ``pack_chunk``'s dispatch: what each stream's ingest
    thread of the multi-stream loop packs."""
    (y, u, v), meta = pack_chunk(frame_bgr[None], size)
    return (y[0], u[0], v[0]), meta
