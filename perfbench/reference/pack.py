"""Plain reference of the host pack and the device letterbox.

The camera frame is resized to the letterbox content size and converted to
planar I420, as the program's packed transport does: an exact 2x2 box
average, 15-bit fixed-point BT.601 luma, float32 chroma in a fixed rounding
sequence with each fused multiply-add rounded once (computed in float64).
Then the planes are turned back into the model input: nearest 2x chroma
upsample, full-range BT.601 to RGB, /255, clip, pad of 114/255, all in
float32.  Written in plain torch so that it runs on the card or the CPU."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Geometry(NamedTuple):
    """The packed letterbox of a (src_h, src_w) camera at model size ``size``."""

    src_h: int
    src_w: int
    size: int
    ch: int          # content height (even)
    cw: int          # content width (even)
    pad_top: int     # even
    pad_left: int    # even


def geometry(src_h: int, src_w: int, size: int) -> Geometry:
    r = min(size / src_h, size / src_w)
    new_w, new_h = round(src_w * r), round(src_h * r)
    ch, cw = (new_h // 2) * 2, (new_w // 2) * 2
    pad_left = (int(round((size - cw) / 2 - 0.1)) // 2) * 2
    pad_top = (int(round((size - ch) / 2 - 0.1)) // 2) * 2
    return Geometry(src_h, src_w, size, ch, cw, pad_top, pad_left)


def _fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once."""
    return (torch.as_tensor(a, dtype=torch.float64) * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


def pack_2x(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, 2ch, 2cw, 3) uint8 BGR -> (y (N, ch, cw), u, v (N, ch/2, cw/2)) uint8."""
    f = frames.to(torch.int32)
    s = f[:, 0::2, 0::2] + f[:, 0::2, 1::2] + f[:, 1::2, 0::2] + f[:, 1::2, 1::2]
    acc = 9798 * s[..., 2] + 19235 * s[..., 1] + 3736 * s[..., 0]
    y = ((acc + (1 << 16)) >> 17).to(torch.uint8)
    c = s[:, 0::2, 0::2] + s[:, 0::2, 1::2] + s[:, 1::2, 0::2] + s[:, 1::2, 1::2]
    c = c.float() * (1.0 / 16.0)
    b4, g4, r4 = c[..., 0], c[..., 1], c[..., 2]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    g = f32(0.587) * g4
    ku, kv = f32(1.0) / f32(1.773), f32(1.0) / f32(1.403)
    if y.shape[2] % 32 == 0:   # the packer's block order
        lum4 = _fma32(f32(0.299), r4, _fma32(f32(0.114), b4, g))
        uf = _fma32(b4 - lum4, ku, f32(128.5))
        vf = _fma32(r4 - lum4, kv, f32(128.5))
    else:
        lum4 = _fma32(f32(0.114), b4, _fma32(f32(0.299), r4, g))
        uf = _fma32(b4 - lum4, ku, f32(128.0)) + 0.5
        vf = _fma32(r4 - lum4, kv, f32(128.0)) + 0.5
    u = uf.clamp(0, 255).to(torch.uint8)
    v = vf.clamp(0, 255).to(torch.uint8)
    return y, u, v


def model_input(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, geo: Geometry
                ) -> torch.Tensor:
    """Planes -> the model's input (N, 3, size, size) float32 RGB in [0, 1]."""
    def up(p: torch.Tensor) -> torch.Tensor:
        return p.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    yf = y.float()
    uf = up(u.float() - 128.0)
    vf = up(v.float() - 128.0)
    r = (yf + 1.403 * vf) / 255.0
    g = (yf - 0.344 * uf - 0.714 * vf) / 255.0
    b = (yf + 1.773 * uf) / 255.0
    rgb = torch.stack([r, g, b], dim=1).clamp(0.0, 1.0)
    out = torch.full((y.shape[0], 3, geo.size, geo.size), 114.0 / 255.0,
                     dtype=torch.float32, device=y.device)
    out[:, :, geo.pad_top:geo.pad_top + geo.ch, geo.pad_left:geo.pad_left + geo.cw] = rgb
    return out


def to_source(boxes: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """Model-input xyxy boxes -> camera pixels, clipped to the frame."""
    sx, sy = geo.cw / geo.src_w, geo.ch / geo.src_h
    shift = boxes.new_tensor([geo.pad_left, geo.pad_top, geo.pad_left, geo.pad_top])
    scale = boxes.new_tensor([sx, sy, sx, sy])
    lim = boxes.new_tensor([geo.src_w, geo.src_h, geo.src_w, geo.src_h])
    return torch.minimum(((boxes - shift) / scale).clamp(min=0.0), lim)
