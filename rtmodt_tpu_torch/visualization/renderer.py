"""Annotated-frame renderer (host-side OpenCV).

The port's copy of ``rtmodt_tpu/visualization/renderer.py``, pixel for
pixel: semi-transparent zone polygons with centroid labels, per-track
colored boxes with ``ID:{id} {class} {conf:.2f}`` labels on filled
backgrounds, centroid trail polylines, and an FPS/latency HUD line.  Colors
come from a 20-entry palette indexed by ``track_id % 20``.  cv2 is imported
inside ``render``, never at import.
"""

from __future__ import annotations

import colorsys
from typing import Sequence

import numpy as np


def _make_palette(n: int = 20) -> list[tuple[int, int, int]]:
    """Evenly hue-spaced, saturation/value-alternated BGR palette."""
    out = []
    for i in range(n):
        h = (i * 0.618033988749895) % 1.0  # golden-ratio hue spacing
        s = 0.85 if i % 2 == 0 else 0.65
        v = 0.95 if i % 3 != 0 else 0.75
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        out.append((int(b * 255), int(g * 255), int(r * 255)))
    return out


_PALETTE = _make_palette(20)


class FrameRenderer:
    def __init__(
        self,
        show_boxes: bool = True,
        show_labels: bool = True,
        show_trails: bool = True,
        show_zones: bool = True,
        show_hud: bool = True,
        trail_length: int = 30,
    ) -> None:
        self.show_boxes = show_boxes
        self.show_labels = show_labels
        self.show_trails = show_trails
        self.show_zones = show_zones
        self.show_hud = show_hud
        self.trail_length = trail_length

    def render(
        self,
        frame: np.ndarray,
        tracks: Sequence,
        zones: Sequence[tuple[str, np.ndarray]] = (),
        fps: float = 0.0,
        latency_ms: float = 0.0,
    ) -> np.ndarray:
        """Draw in place and return the frame."""
        import cv2

        if self.show_zones and zones:
            overlay = frame.copy()
            pts_all = []
            for name, poly in zones:
                pts = np.asarray(poly, np.int32).reshape(-1, 1, 2)
                cv2.fillPoly(overlay, [pts], (60, 160, 255))
                pts_all.append((name, pts))
            cv2.addWeighted(overlay, 0.25, frame, 0.75, 0, frame)
            # outlines + labels AFTER the blend so they stay crisp instead
            # of being washed out under the semi-transparent fill
            for name, pts in pts_all:
                cv2.polylines(frame, [pts], True, (60, 160, 255), 2)
                m = cv2.moments(pts)
                if m["m00"] > 0:
                    cx, cy = int(m["m10"] / m["m00"]), int(m["m01"] / m["m00"])
                    cv2.putText(frame, name, (cx - 40, cy), cv2.FONT_HERSHEY_SIMPLEX,
                                0.6, (255, 255, 255), 2, cv2.LINE_AA)

        for t in tracks:
            color = _PALETTE[t.track_id % len(_PALETTE)]
            x1, y1, x2, y2 = (int(v) for v in t.xyxy)
            if self.show_boxes:
                cv2.rectangle(frame, (x1, y1), (x2, y2), color, 2)
            if self.show_labels:
                label = f"ID:{t.track_id} {t.class_name} {t.confidence:.2f}"
                (tw, th), baseline = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
                y_text = max(y1, th + 4)
                cv2.rectangle(frame, (x1, y_text - th - 4), (x1 + tw + 2, y_text + baseline - 2),
                              color, -1)
                cv2.putText(frame, label, (x1 + 1, y_text - 2), cv2.FONT_HERSHEY_SIMPLEX,
                            0.5, (0, 0, 0), 1, cv2.LINE_AA)
            if self.show_trails and len(t.trail) > 1:
                pts = np.asarray(t.trail[-self.trail_length:], np.int32).reshape(-1, 1, 2)
                cv2.polylines(frame, [pts], False, color, 2)

        if self.show_hud:
            hud = f"FPS: {fps:.1f} | Latency: {latency_ms:.1f} ms"
            cv2.putText(frame, hud, (10, 30), cv2.FONT_HERSHEY_SIMPLEX,
                        0.8, (0, 255, 0), 2, cv2.LINE_AA)
        return frame
