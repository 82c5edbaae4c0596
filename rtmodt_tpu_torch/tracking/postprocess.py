"""Offline track post-processing: linear gap interpolation.

The port's copy of ``rtmodt_tpu/tracking/postprocess.py`` (numpy only).
The ByteTrack paper's standard offline trick: when a track disappears for a
few frames (occlusion, missed detection) and re-associates under the SAME
id, fill the gap with linearly interpolated boxes.  Purely host-side and
offline - it needs future frames, so it never runs on the live path; it
raises MOTA/recall for recorded-video evaluation (``run_inference_torch
track --interpolate``).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def interpolate_mot_rows(rows: list[tuple], max_gap: int = 20) -> list[tuple]:
    """Fill per-id frame gaps of 2..max_gap frames with linear boxes.

    ``rows``: MOT15-2D tuples ``(frame, track_id, x, y, w, h, conf)`` (extra
    trailing fields are preserved on observed rows; interpolated rows carry
    the linearly blended box and the min of the endpoint confidences).
    Returns the rows plus interpolated ones, sorted by (frame, id).
    """
    by_id: dict[int, list[tuple]] = defaultdict(list)
    for r in rows:
        by_id[int(r[1])].append(r)

    out = list(rows)
    for tid, trows in by_id.items():
        trows.sort(key=lambda r: r[0])
        for a, b in zip(trows, trows[1:]):
            gap = int(b[0]) - int(a[0])
            if gap <= 1 or gap > max_gap:
                continue
            box_a = np.asarray(a[2:6], np.float64)
            box_b = np.asarray(b[2:6], np.float64)
            conf = min(float(a[6]) if len(a) > 6 else 1.0,
                       float(b[6]) if len(b) > 6 else 1.0)
            for k in range(1, gap):
                w = k / gap
                box = (1.0 - w) * box_a + w * box_b
                out.append((int(a[0]) + k, tid, *box.tolist(), conf))
    out.sort(key=lambda r: (r[0], r[1]))
    return out


def load_mot_rows(path: str) -> list[tuple]:
    """MOT15-2D txt -> (frame, id, x, y, w, h, conf) tuples."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.replace(";", ",").split(",")
            if len(parts) < 6:
                continue
            rows.append((int(float(parts[0])), int(float(parts[1])),
                         float(parts[2]), float(parts[3]), float(parts[4]),
                         float(parts[5]),
                         float(parts[6]) if len(parts) > 6 else 1.0))
    return rows


def write_mot_rows(path: str, rows: list[tuple]) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(f"{int(r[0])},{int(r[1])},{r[2]:.2f},{r[3]:.2f},"
                    f"{r[4]:.2f},{r[5]:.2f},{r[6]:.4f},-1,-1,-1\n")
