"""Camera frames of the benchmark's traffic, made from the run's seed.

Frozen copies of two scene generators of the program's ``utils/synthetic.py``
(kept here so that the traffic cannot move with the program):

  * ``moving_boxes``: coloured rectangles bouncing off the frame edges at
    constant speed on a flat grey background, drawn exactly as
    ``moving_boxes_frame`` draws them;
  * ``dense``: ``dense_moving_scene``'s crowd of persistent shapes (8 shape
    classes, sizes shrinking with density, a textured background).  The
    shapes are rasterised here with numpy masks instead of cv2's polygon
    fill, so pixels on a shape's edge may differ from the original's.

A stream's frames live in a pool ``(2F, S, H, W, 3)`` uint8 in host
memory: position ``q`` holds every stream's frame at scene time ``q`` for
``q < F``, and at ``2F - 1 - q`` after that, so the F distinct frames play
forward, then backward, and motion stays continuous while the pool stays
small.  Camera frame ``i`` is position ``i % 2F``; its scene time is
``pool_index(i, F)``.  With ``2F`` a multiple of the chunk's T, a chunk's
frames are one contiguous block ``(T, S, H, W, 3)``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SCENES = ("moving_boxes", "dense")


def stream_seed(seed: int, stream: int) -> int:
    """The scene seed of one stream of a run (different for every stream)."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), stream]).generate_state(1)[0])


def pool_index(i: int, pool_frames: int) -> int:
    """Pool position of camera frame ``i``: 0, 1, ..., F-1, F-1, ..., 0, 0, ..."""
    r = i % (2 * pool_frames)
    return r if r < pool_frames else 2 * pool_frames - 1 - r


# -- moving_boxes (utils/synthetic.py::moving_boxes_frame) ---------------------

def _boxes_params(n_objects: int, seed: int):
    rng = np.random.default_rng(seed)
    base_xy = rng.uniform([0.05, 0.05], [0.7, 0.7], (n_objects, 2))
    sizes = rng.uniform([0.06, 0.1], [0.12, 0.22], (n_objects, 2))
    vel = rng.uniform(-0.01, 0.01, (n_objects, 2))
    colors = rng.integers(60, 255, (n_objects, 3))
    return base_xy, sizes, vel, colors


def moving_boxes_frame(t: int, h: int, w: int, n_objects: int, seed: int,
                       out: np.ndarray | None = None) -> np.ndarray:
    """Frame t of the bouncing-rectangles scene, BGR uint8 (h, w, 3)."""
    base_xy, sizes, vel, colors = _boxes_params(n_objects, seed)
    frame = np.empty((h, w, 3), np.uint8) if out is None else out
    frame[:] = 30
    for i in range(n_objects):
        span = 1.0 - sizes[i]
        pos = base_xy[i] + vel[i] * t
        pos = np.abs(((pos / span) % 2.0) - 1.0) * span   # reflect off the walls
        x1, y1 = int(pos[0] * w), int(pos[1] * h)
        x2, y2 = int((pos[0] + sizes[i][0]) * w), int((pos[1] + sizes[i][1]) * h)
        frame[y1:y2, x1:x2] = colors[i]
    return frame


# -- dense (utils/synthetic.py::dense_moving_scene) ----------------------------

SHAPE_CLASSES = ("box", "disc", "triangle", "ring", "cross", "diamond", "stripe_v", "star")


def _dense_params(h: int, w: int, n_objects: int, n_classes: int, seed: int):
    rng = np.random.default_rng(seed)
    n_classes = min(n_classes, len(SHAPE_CLASSES))
    cls = rng.integers(0, n_classes, n_objects)
    s_hi = 0.5 * np.sqrt(0.45 * h * w / max(1, n_objects))
    sizes = np.maximum(14, rng.uniform(0.55, 1.0, n_objects) * s_hi).astype(int)
    colors = rng.integers(90, 255, (n_objects, 3))
    base = rng.uniform(0.0, 1.0, (n_objects, 2))
    vel = rng.uniform(0.004, 0.012, (n_objects, 2)) * rng.choice([-1.0, 1.0], (n_objects, 2))
    return cls, sizes, colors, base, vel


def dense_background(h: int, w: int, seed: int) -> np.ndarray:
    """The scene's textured background (gradient and noise), the same in
    every frame of one scene."""
    bg_rng = np.random.default_rng(seed ^ 0x5EED)
    # the original's mgrid, as a row and a column: the same values a pixel
    gx = np.arange(w, dtype=np.float32)[None, :]
    gy = np.arange(h, dtype=np.float32)[:, None]
    ang = bg_rng.uniform(0, 2 * np.pi)
    grad = np.cos(ang) * gx / w + np.sin(ang) * gy / h
    grad = (grad - grad.min()) / (np.ptp(grad) + 1e-9)
    bg = (30 + 70 * grad)[..., None] * bg_rng.uniform(0.5, 1.0, (3,))
    bg += bg_rng.normal(0, 8, (h, w, 3))
    return np.clip(bg, 0, 255, out=bg).astype(np.uint8)


def _inside_polygon(px: np.ndarray, py: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Even-odd point-in-polygon test of pixel centres."""
    inside = np.zeros(px.shape, bool)
    n = len(pts)
    for i in range(n):
        x0, y0 = pts[i]
        x1, y1 = pts[(i + 1) % n]
        if y0 == y1:
            continue
        straddle = (y0 > py) != (y1 > py)
        xc = x0 + (py - y0) * (x1 - x0) / (y1 - y0)
        inside ^= straddle & (px < xc)
    return inside


def _shape_mask(name: str, s: int) -> np.ndarray:
    """Mask of one shape of half-size ``s`` on its (2s+1, 2s+1) square."""
    yy, xx = np.mgrid[-s:s + 1, -s:s + 1].astype(np.float64)
    if name == "box":
        return np.ones(yy.shape, bool)
    if name == "disc":
        return xx * xx + yy * yy <= s * s
    if name == "triangle":
        pts = np.array([[0, -s], [-s, s], [s, s]], np.float64)
        return _inside_polygon(xx + 0.5, yy + 0.5, pts) | (yy == s)
    if name == "ring":
        t = max(3, s // 3)
        r = np.sqrt(xx * xx + yy * yy)
        return np.abs(r - s) <= t / 2.0
    if name == "cross":
        t = max(3, s // 3)
        return (np.abs(xx) <= t) | (np.abs(yy) <= t)
    if name == "diamond":
        return np.abs(xx) + np.abs(yy) <= s
    if name == "stripe_v":
        return np.abs(xx) <= max(3, s // 2)
    if name == "star":
        a = np.linspace(-np.pi / 2, 1.5 * np.pi, 11)[:-1]
        r = np.where(np.arange(10) % 2 == 0, s, s * 0.45)
        pts = np.stack([r * np.cos(a), r * np.sin(a)], -1)
        return _inside_polygon(xx + 0.5, yy + 0.5, pts)
    raise ValueError(f"unknown shape {name!r}")


class DenseScene:
    """``dense_moving_scene`` of one seed: its background and masks are
    made once, its frames drawn by ``frame(t)``."""

    def __init__(self, h: int, w: int, n_objects: int, seed: int, n_classes: int = 8):
        self.h, self.w = h, w
        self.cls, self.sizes, self.colors, self.base, self.vel = _dense_params(
            h, w, n_objects, n_classes, seed)
        self.bg = dense_background(h, w, seed)
        self.masks = [_shape_mask(SHAPE_CLASSES[int(c)], int(s))
                      for c, s in zip(self.cls, self.sizes)]

    def frame(self, t: int, out: np.ndarray | None = None) -> np.ndarray:
        h, w = self.h, self.w
        frame = np.empty((h, w, 3), np.uint8) if out is None else out
        frame[:] = self.bg
        for i, mask in enumerate(self.masks):
            s = int(self.sizes[i])
            px = abs(((self.base[i, 0] + self.vel[i, 0] * t) % 2.0) - 1.0)
            py = abs(((self.base[i, 1] + self.vel[i, 1] * t) % 2.0) - 1.0)
            cx = s + int(px * max(1, w - 2 * s))
            cy = s + int(py * max(1, h - 2 * s))
            # clip the shape's square to the frame
            y0, x0 = cy - s, cx - s
            ys, xs = max(0, y0), max(0, x0)
            ye, xe = min(h, cy + s + 1), min(w, cx + s + 1)
            m = mask[ys - y0:ye - y0, xs - x0:xe - x0]
            frame[ys:ye, xs:xe][m] = self.colors[i]
        return frame


def make_pool(scene: str, streams: int, pool_frames: int, h: int, w: int,
              objects: int, seed: int, workers: int | None = None) -> np.ndarray:
    """Every stream's frames of a run: ``(2F, S, H, W, 3)`` uint8 (the
    second half the first in reverse), stream s drawn from
    ``stream_seed(seed, s)``.  Streams are drawn on ``workers`` threads (by
    default one a core, at most 8; numpy's fills and copies let go of the
    GIL); each stream's frames depend on its seed alone."""
    if scene not in SCENES:
        raise ValueError(f"unknown scene {scene!r}; known: {SCENES}")
    pool = np.empty((2 * pool_frames, streams, h, w, 3), np.uint8)

    def draw(s: int) -> None:
        ss = stream_seed(seed, s)
        if scene == "moving_boxes":
            for p in range(pool_frames):
                moving_boxes_frame(p, h, w, objects, ss, out=pool[p, s])
        else:
            sc = DenseScene(h, w, objects, ss)
            for p in range(pool_frames):
                sc.frame(p, out=pool[p, s])
        pool[pool_frames:, s] = pool[pool_frames - 1::-1, s]

    workers = workers or min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=max(1, min(workers, streams))) as ex:
        list(ex.map(draw, range(streams)))
    return pool
