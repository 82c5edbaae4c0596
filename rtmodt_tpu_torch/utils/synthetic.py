"""Synthetic scenes for tests and smoke runs, drawn in numpy (no cv2).

``moving_boxes_frame`` is the port's copy of the reference package's
generator of the same name: the same seeded scene, pixel for pixel."""

from __future__ import annotations

import numpy as np


def moving_boxes_frame(t: int, h: int = 720, w: int = 1280, n_objects: int = 6,
                       seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Frame t of a deterministic scene of colored rectangles bouncing off
    the frame edges at constant speed.  Returns (BGR uint8 (h, w, 3),
    gt boxes (n, 4) xyxy float32)."""
    rng = np.random.default_rng(seed)
    base_xy = rng.uniform([0.05, 0.05], [0.7, 0.7], (n_objects, 2))
    sizes = rng.uniform([0.06, 0.1], [0.12, 0.22], (n_objects, 2))
    vel = rng.uniform(-0.01, 0.01, (n_objects, 2))
    colors = rng.integers(60, 255, (n_objects, 3))

    frame = np.full((h, w, 3), 30, np.uint8)
    boxes = np.zeros((n_objects, 4), np.float32)
    for i in range(n_objects):
        span = 1.0 - sizes[i]
        pos = base_xy[i] + vel[i] * t
        pos = np.abs(((pos / span) % 2.0) - 1.0) * span   # reflect off the walls
        x1, y1 = int(pos[0] * w), int(pos[1] * h)
        x2, y2 = int((pos[0] + sizes[i][0]) * w), int((pos[1] + sizes[i][1]) * h)
        frame[y1:y2, x1:x2] = colors[i]
        boxes[i] = (x1, y1, x2, y2)
    return frame, boxes
