"""Packed planar I420 transport: host pack (numpy) and device unpack (torch).

Port of ``rtmodt_tpu/ops/yuv.py``.  The host resizes each BGR frame to the
letterbox content size and converts it to planar Y/U/V (12 bits/px, 7.5x
fewer bytes than 720p BGR); the device upsamples chroma, converts BT.601 to
RGB, normalises and pads to the model input in ``planar_letterbox``.

``pack_chunk`` dispatches as the reference does: the port's native packer
(``ops/framepack.py``, C++ built on first use) on the exact integer
downsamples where it is fastest (720p -> 640x360 is 2x, 1080p -> 640x360 is
3x), cv2's bilinear resize and I420 conversion on every other geometry.

A caller's pre-packed chunk of the space-to-depth transports
(``parallel.transport: x6 | x24``, packed on the host by ``planes_to_x6`` /
``planes_to_x24`` as the reference packs them) is unpacked on the device
(``x6_to_planes``, ``x24_to_planes``); ``s2d_level`` holds it to the
reference's rule for its level.
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


# -- the space-to-depth transports (parallel.transport: x6 | x24) -------------
# The reference ships these layouts to feed its TPU space-to-depth stem; the
# link bytes equal planar I420, so the port's own loops ship the planes.  A
# caller may still hand over a chunk packed as the reference packs it (byte
# for byte); the device unpacks it to planes, where ``planar_letterbox`` takes
# them as from any other transport.

def planes_to_x6(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                 out: np.ndarray | None = None) -> np.ndarray:
    """Planar I420 chunk ``y (N, ch, cw)``, ``u, v (N, ch/2, cw/2)`` -> one
    ``(N, ch/2, cw/2, 6)`` uint8 array: the four Y parities (channel ``2p +
    q`` holds row parity p, column parity q), then U, V."""
    n, ch, cw = y.shape
    if out is None:
        out = np.empty((n, ch // 2, cw // 2, 6), np.uint8)
    ys = y.reshape(n, ch // 2, 2, cw // 2, 2)
    out[..., 0] = ys[:, :, 0, :, 0]
    out[..., 1] = ys[:, :, 0, :, 1]
    out[..., 2] = ys[:, :, 1, :, 0]
    out[..., 3] = ys[:, :, 1, :, 1]
    out[..., 4] = u
    out[..., 5] = v
    return out


def planes_to_x24(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  out: np.ndarray | None = None) -> np.ndarray:
    """Planar I420 chunk -> ``(N, ch/4, cw/4, 24)`` uint8, the double
    space-to-depth layout: channel ``c6 * 4 + g2``, ``c6`` the x6 channel and
    ``g2 = 2 * p2 + q2`` the second-level 2x2 parity.  Needs content dims
    divisible by 4 (``s2d_level``)."""
    n, ch, cw = y.shape
    if out is None:
        out = np.empty((n, ch // 4, cw // 4, 24), np.uint8)
    # full-resolution row r = 4I + m with m = 2 * p2 + p1; columns likewise
    ys = y.reshape(n, ch // 4, 4, cw // 4, 4)
    for m in range(4):
        p2, p1 = divmod(m, 2)
        for mm in range(4):
            q2, q1 = divmod(mm, 2)
            out[..., (2 * p1 + q1) * 4 + 2 * p2 + q2] = ys[:, :, m, :, mm]
    us = u.reshape(n, ch // 4, 2, cw // 4, 2)
    vs = v.reshape(n, ch // 4, 2, cw // 4, 2)
    for p2 in (0, 1):
        for q2 in (0, 1):
            out[..., 16 + 2 * p2 + q2] = us[:, :, p2, :, q2]
            out[..., 20 + 2 * p2 + q2] = vs[:, :, p2, :, q2]
    return out


def x6_to_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact inverse of ``planes_to_x6`` on ``x (..., ch/2, cw/2, 6)``:
    (y (..., ch, cw), u, v (..., ch/2, cw/2))."""
    *lead, h2, w2, _ = x.shape
    y = (x[..., :4].reshape(*lead, h2, w2, 2, 2).movedim(-2, -3)
         .reshape(*lead, 2 * h2, 2 * w2))
    return y, x[..., 4], x[..., 5]


def x24_to_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact inverse of ``planes_to_x24`` on ``x (..., ch/4, cw/4, 24)``."""
    *lead, h4, w4, _ = x.shape
    nl = len(lead)
    # Y channels (p1, q1, p2, q2) -> rows (p2, p1), columns (q2, q1)
    ys = x[..., :16].reshape(*lead, h4, w4, 2, 2, 2, 2)
    i, j, p1, q1, p2, q2 = range(nl, nl + 6)
    y = ys.permute(*range(nl), i, p2, p1, j, q2, q1).reshape(*lead, 4 * h4, 4 * w4)

    def chroma(c: torch.Tensor) -> torch.Tensor:      # channels (p2, q2)
        return (c.reshape(*lead, h4, w4, 2, 2).movedim(-2, -3)
                .reshape(*lead, 2 * h4, 2 * w4))

    return y, chroma(x[..., 16:20]), chroma(x[..., 20:24])


def s2d_to_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An x6 or x24 tensor (by its channel count) back to its planes."""
    c = x.shape[-1]
    if c == 6:
        return x6_to_planes(x)
    if c == 24:
        return x24_to_planes(x)
    raise ValueError(f"a space-to-depth tensor has 6 or 24 channels, got {c}")


def s2d_level(transport: str, src_h: int, src_w: int, size: int,
              appearance: bool = False) -> int:
    """The reference's space-to-depth level of a source geometry: 2 = x24,
    1 = x6, 0 = planar.  ``x6`` pins 1; ``x24`` pins 2 and raises where the
    content dims or the letterbox pads are not divisible by 4; ``packed``
    picks x24 where eligible, else x6, and planar for the appearance
    trackers (their crops need the planes); ``i420`` and ``bgr`` are planar.
    Unlike the reference, ``packed`` does not ask for two host cores before
    it picks x24: that rule weighs the host's x24 repack against the TPU's
    stem, and the port never repacks, so here the level only says which
    pre-packed layouts a caller may hand over."""
    if transport not in ("x6", "x24") and not (transport == "packed" and not appearance):
        return 0
    ch, cw = content_dims(src_h, src_w, size)
    meta = packed_meta(src_h, src_w, size)
    ok24 = ch % 4 == 0 and cw % 4 == 0 and meta.pad_left % 4 == 0 and meta.pad_top % 4 == 0
    if transport == "x6":
        return 1
    if transport == "x24":
        if not ok24:
            raise ValueError(
                f"parallel.transport=x24 pinned but source {src_w}x{src_h} -> content "
                f"{cw}x{ch} (pads {meta.pad_left},{meta.pad_top}) is not divisible by 4; "
                "use transport=packed for auto-selection")
        return 2
    return 2 if ok24 else 1


def check_prepacked(x, transport: str, src_h: int, src_w: int, size: int,
                    appearance: bool = False) -> int:
    """The reference's checks of a pre-packed x6/x24 chunk; returns its level.
    A worker-built tensor picks its own level: x6 stays valid where auto
    would pick x24; x24 needs an x24 geometry; a pinned level must match."""
    level = s2d_level(transport, src_h, src_w, size, appearance)
    if level == 0:
        raise ValueError("pre-packed s2d tensor submitted but the active transport is not "
                         "s2d (appearance tracker, or a pinned i420/bgr layout)")
    got = {6: 1, 24: 2}.get(int(x.shape[-1]))
    if (got is None or (got == 2 and level != 2) or (transport == "x6" and got != 1)
            or (transport == "x24" and got != 2)):
        raise ValueError(f"pre-packed tensor has {x.shape[-1]} channels; transport="
                         f"{transport!r} with this geometry expects "
                         f"{'6 (x6)' if level == 1 else '6 or 24'}")
    return got
