"""Plain reference of the zone events, one stream, frame by frame.

Per visible track and zone, in slot order (the track's centroid is the
float32 mean of its box corners; containment by the even-odd rule):

  * intrusion (dwell): the entry time is kept while the track stays inside;
    once inside for ``dwell_time_sec`` of stream time, an event, at most one
    per (track, zone) every ``cooldown_sec``;
  * crossing: an event when the track enters the zone, moving in the zone's
    direction (over the track's last ``trail_length`` visible centroids,
    truncated to whole pixels), at most one per (track, zone) every
    ``cooldown_sec``.

A track that is not visible in a frame loses its zone entries."""

from __future__ import annotations

from collections import deque

import numpy as np


def inside_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """(N, 2) float64 points in one (K, 2) polygon, even-odd rule."""
    px, py = pts[:, 0][:, None], pts[:, 1][:, None]
    vx, vy = poly[:, 0][None, :], poly[:, 1][None, :]
    nx, ny = np.roll(poly[:, 0], -1)[None, :], np.roll(poly[:, 1], -1)[None, :]
    straddle = (vy > py) != (ny > py)
    denom = np.where(np.abs(ny - vy) < 1e-12, 1e-12, ny - vy)
    x_cross = vx + (py - vy) / denom * (nx - vx)
    return (np.sum(straddle & (px < x_cross), axis=1) % 2) == 1


DIRECTIONS = {"left_to_right": (0, 1), "right_to_left": (0, -1),
              "top_to_bottom": (1, 1), "bottom_to_top": (1, -1)}


class ZonesRef:
    def __init__(self, zones: list[dict], trail_length: int):
        self.zones = [dict(z, polygon=np.asarray(z["polygon"], np.float32)) for z in zones]
        self.trail_length = trail_length
        self.occupancy: dict[int, dict[str, float]] = {}
        self.cooldown: dict[tuple[int, str], float] = {}
        self.trails: dict[int, deque] = {}

    def _direction_ok(self, zone: dict, tid: int) -> bool:
        d = zone.get("direction")
        if not d:
            return True
        trail = self.trails[tid]
        if len(trail) < 2:
            return False
        axis, sign = DIRECTIONS.get(d, (0, 0))
        if sign == 0:
            return True
        delta = trail[-1][axis] - trail[0][axis]
        return delta > 0 if sign > 0 else delta < 0

    def frame(self, tids, classes, boxes, visible, fid: int, ts: float) -> list[tuple]:
        """One frame's tracks (slot arrays) -> events as (frame_id, zone,
        type, track_id, class_id, dwell_s, slot)."""
        slots = np.where(visible)[0]
        b = boxes[slots].astype(np.float32)
        cents = (b[:, 0:2] + b[:, 2:4]) * np.float32(0.5)
        inside = np.stack([inside_polygon(cents.astype(np.float64), z["polygon"])
                           for z in self.zones], axis=1) if len(slots) else None
        events = []
        for j, sl in enumerate(slots):
            tid = int(tids[sl])
            trail = self.trails.setdefault(tid, deque(maxlen=self.trail_length))
            trail.append((float(np.trunc(cents[j, 0])), float(np.trunc(cents[j, 1]))))
        for j, sl in enumerate(slots):
            tid, cid = int(tids[sl]), int(classes[sl])
            for zi, z in enumerate(self.zones):
                if z.get("classes") is not None and cid not in z["classes"]:
                    continue
                occ = self.occupancy.get(tid, {})
                if not inside[j, zi]:
                    occ.pop(z["name"], None)
                    continue
                was = occ.get(z["name"])
                self.occupancy.setdefault(tid, {}).setdefault(z["name"], ts)
                key = (tid, z["name"])
                cool = ts - self.cooldown.get(key, -1e18) >= z.get("cooldown_sec", 10.0)
                if z.get("trigger", "intrusion") == "crossing":
                    if was is None and self._direction_ok(z, tid) and cool:
                        events.append((fid, z["name"], "crossing", tid, cid, 0.0, int(sl)))
                        self.cooldown[key] = ts
                    continue
                dwell = ts - self.occupancy[tid][z["name"]]
                if dwell >= z.get("dwell_time_sec", 2.0) and cool:
                    events.append((fid, z["name"], z.get("trigger", "intrusion"), tid, cid,
                                   round(dwell, 2), int(sl)))
                    self.cooldown[key] = ts
        alive = {int(tids[sl]) for sl in slots}
        for tid in set(self.occupancy) - alive:
            del self.occupancy[tid]
        return events
