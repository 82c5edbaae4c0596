"""Letterbox geometry (host math only), as in ``rtmodt_tpu/ops/letterbox.py``.

Geometry matches ultralytics' LetterBox: scale ``r = min(S/h, S/w)``, content
``(round(h*r), round(w*r))``, pads split as ``round(d - 0.1)``.
"""

from __future__ import annotations

from typing import NamedTuple


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
