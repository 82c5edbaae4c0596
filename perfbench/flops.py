"""Operations of one YOLOv8 forward, counted from the configuration's sizes.

The layer list of Ultralytics' ``cfg/models/v8/yolov8.yaml`` (backbone,
SPPF, PAN neck, Detect head) at the configuration's ``depth_multiple``,
``width_multiple``, ``max_channels``, ``nc`` and ``reg_max``.  Each
convolution costs 2 x (output elements x input channels x kernel area)
operations; the DFL's 1x1 expectation conv over every anchor is counted
too.  Pooling, upsampling, concatenation, BN (folded) and activations are
not counted, as Ultralytics' figure does not count them."""

from __future__ import annotations

import math


def _div8(x: float) -> int:
    return int(math.ceil(x / 8) * 8)


def conv_shapes(cfg: dict, imgsz: int) -> list[tuple[int, int, int, int]]:
    """(c_in, c_out, kernel, output side) of every convolution of a square
    ``imgsz`` input."""
    d, w, mc = cfg["depth_multiple"], cfg["width_multiple"], cfg["max_channels"]
    nc, reg = cfg["nc"], cfg.get("reg_max", 16)
    ch = lambda c: _div8(min(c, mc) * w)  # noqa: E731
    rep = lambda n: max(round(n * d), 1)  # noqa: E731
    out: list[tuple[int, int, int, int]] = []

    def conv(c1: int, c2: int, k: int, side: int) -> None:
        out.append((c1, c2, k, side))

    def c2f(c1: int, c2: int, n: int, side: int) -> None:
        c = int(c2 * 0.5)
        conv(c1, 2 * c, 1, side)
        for _ in range(n):
            conv(c, c, 3, side)
            conv(c, c, 3, side)
        conv((2 + n) * c, c2, 1, side)

    s = imgsz
    conv(3, ch(64), 3, s // 2)
    conv(ch(64), ch(128), 3, s // 4)
    c2f(ch(128), ch(128), rep(3), s // 4)
    conv(ch(128), ch(256), 3, s // 8)
    c2f(ch(256), ch(256), rep(6), s // 8)
    conv(ch(256), ch(512), 3, s // 16)
    c2f(ch(512), ch(512), rep(6), s // 16)
    conv(ch(512), ch(1024), 3, s // 32)
    c2f(ch(1024), ch(1024), rep(3), s // 32)
    c_ = ch(1024) // 2                                   # SPPF
    conv(ch(1024), c_, 1, s // 32)
    conv(4 * c_, ch(1024), 1, s // 32)
    c2f(ch(1024) + ch(512), ch(512), rep(3), s // 16)    # top-down P4
    c2f(ch(512) + ch(256), ch(256), rep(3), s // 8)      # top-down P3
    conv(ch(256), ch(256), 3, s // 16)
    c2f(ch(256) + ch(512), ch(512), rep(3), s // 16)     # bottom-up P4
    conv(ch(512), ch(512), 3, s // 32)
    c2f(ch(512) + ch(1024), ch(1024), rep(3), s // 32)   # bottom-up P5
    levels = (ch(256), ch(512), ch(1024))
    c2 = max(16, levels[0] // 4, reg * 4)
    c3 = max(levels[0], min(nc, 100))
    for c, side in zip(levels, (s // 8, s // 16, s // 32)):
        conv(c, c2, 3, side)
        conv(c2, c2, 3, side)
        conv(c2, 4 * reg, 1, side)
        conv(c, c3, 3, side)
        conv(c3, c3, 3, side)
        conv(c3, nc, 1, side)
    return out


def forward_flops(cfg: dict, imgsz: int) -> float:
    """Operations (2 x multiply-adds) of one frame's forward."""
    macs = sum(c1 * c2 * k * k * side * side for c1, c2, k, side in conv_shapes(cfg, imgsz))
    anchors = sum((imgsz // st) ** 2 for st in (8, 16, 32))
    macs += 4 * anchors * cfg.get("reg_max", 16)          # the DFL's 1x1 conv
    return 2.0 * macs
