"""Polygon zone-intrusion, crossing and dwell-time events.

The port's own copy of ``rtmodt_tpu/events/zone_engine.py``, unchanged in
behaviour: the same event JSONL schema (timestamp_utc, event_type,
zone_name, track_id, class_id, class_name, dwell_time_sec, bbox_xyxy,
centroid, frame_id, metadata), dwell >= ``dwell_time_sec`` with
per-(track, zone) cooldowns, stream-time clocks by default.  It runs on the
host in numpy: ``process`` over one frame's Track list (the per-frame
paths), ``process_chunk`` over the ``(K, S)`` outputs of a chunk.  Alert
backends: ``json_file`` and ``webhook`` (mqtt is ROADMAP item 6).
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field, replace
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from rtmodt_tpu_torch.config.loader import AlertConfig, EventsConfig, ZoneConfig
from rtmodt_tpu_torch.utils.logging import logger


@dataclass
class ZoneEvent:
    """Immutable event record - field-for-field the reference schema
    (zone_engine.py:29-45)."""

    timestamp_utc: str
    event_type: str               # intrusion | crossing
    zone_name: str
    track_id: int
    class_id: int
    class_name: str
    dwell_time_sec: float
    bbox_xyxy: list[float]
    centroid: list[int]
    frame_id: int
    metadata: dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), default=str)


@dataclass
class Zone:
    name: str
    polygon: np.ndarray           # (K, 2) float32
    trigger: str = "intrusion"
    dwell_time_sec: float = 2.0
    cooldown_sec: float = 10.0
    direction: Optional[str] = None
    classes: Optional[list[int]] = None


def _points_in_polygons_np(points: np.ndarray, polys: list[np.ndarray]) -> np.ndarray:
    """(N, 2) points x list of (K_i, 2) polygons -> (N, Z) bool, even-odd rule.
    Crossing test per polygon edge, vectorized over points."""
    n = len(points)
    out = np.zeros((n, len(polys)), dtype=bool)
    if n == 0:
        return out
    px = points[:, 0][:, None]
    py = points[:, 1][:, None]
    for zi, poly in enumerate(polys):
        vx, vy = poly[:, 0][None, :], poly[:, 1][None, :]
        nx, ny = np.roll(poly[:, 0], -1)[None, :], np.roll(poly[:, 1], -1)[None, :]
        straddle = (vy > py) != (ny > py)
        denom = np.where(np.abs(ny - vy) < 1e-12, 1e-12, ny - vy)
        x_cross = vx + (py - vy) / denom * (nx - vx)
        out[:, zi] = (np.sum(straddle & (px < x_cross), axis=1) % 2) == 1
    return out


class ZoneEventEngine:
    """Evaluate tracks against polygon zones and emit alert events."""

    def __init__(
        self,
        zone_configs: Sequence[ZoneConfig | dict],
        log_path: str | None = None,
        alert: AlertConfig | None = None,
        clock: str = "stream",
        trail_length: int = 30,
    ) -> None:
        self.zones = [self._parse_zone(z) for z in zone_configs]
        # copy: several engines may share one EventsConfig.alert instance
        # (multi-camera), and the log_path override below must not leak into
        # the caller's config object
        self.alert = replace(alert) if alert is not None else AlertConfig()
        if log_path is not None:
            self.alert.log_path = log_path
        self.clock = clock
        self.log_path = Path(self.alert.log_path)
        self.log_path.parent.mkdir(parents=True, exist_ok=True)

        # merged into every event's metadata (e.g. {"stream": 3} in the
        # multi-stream runner, which keeps one engine per camera)
        self.extra_metadata: dict[str, Any] = {}
        # track_id -> {zone_name -> first_seen_time}
        self._occupancy: dict[int, dict[str, float]] = {}
        # per-zone analytics (framework extension; the reference only logs
        # alerts): entry transitions + distinct track ids ever entered.
        # Counted identically by the per-frame and chunked paths.
        self._counts: dict[str, dict] = {
            z.name: {"entries": 0, "tids": set()} for z in self.zones}
        # (track_id, zone_name) -> last_alert_time
        self._cooldown: dict[tuple[int, str], float] = {}
        # per-SLOT centroid history for the chunked array path (direction
        # gating): lazily sized to the tracker's slot count on first chunk
        self._trail_maxlen = trail_length
        self._hist: np.ndarray | None = None      # (S, L, 2) float64
        self._hist_len: np.ndarray | None = None  # (S,) int32
        self._hist_tid: np.ndarray | None = None  # (S,) int64
        self._last_wall_chunk: float | None = None  # wall-clock interpolation
        logger.info(f"ZoneEventEngine loaded {len(self.zones)} zones "
                    f"(clock={clock}, backend={self.alert.backend})")

    @classmethod
    def from_config(cls, cfg: EventsConfig, trail_length: int = 30) -> "ZoneEventEngine":
        return cls(cfg.zones, alert=cfg.alert, clock=cfg.clock,
                   trail_length=trail_length)

    # ------------------------------------------------------------------
    # -- checkpoint / resume (runtime/state_store.py) ---------------------------
    def state_dict(self) -> dict:
        """JSON-serialisable engine state: dwell timers, cooldowns, per-zone
        counts, the chunked path's centroid history, and the event log's size
        in bytes at this moment (``log_offset``: a downstream consumer tells
        the events before the snapshot from those after it).  Every event is
        written with its own open/close, so the size is on disk."""
        d: dict[str, Any] = {
            "occupancy": [[int(tid), zn, float(t)]
                          for tid, occ in self._occupancy.items() for zn, t in occ.items()],
            "cooldown": [[int(tid), zn, float(t)] for (tid, zn), t in self._cooldown.items()],
            "counts": {zn: {"entries": int(c["entries"]), "tids": sorted(int(t) for t in c["tids"])}
                       for zn, c in self._counts.items()},
            "last_wall_chunk": self._last_wall_chunk,
            "log_offset": self.log_path.stat().st_size if self.log_path.exists() else 0,
        }
        if self._hist is not None:
            d["hist"] = {"pts": self._hist.tolist(), "len": self._hist_len.tolist(),
                         "tid": self._hist_tid.tolist()}
        return d

    def load_state_dict(self, d: dict) -> None:
        """Inverse of ``state_dict`` (counts of zones this engine lacks are
        dropped)."""
        self._occupancy.clear()
        for tid, zn, t in d.get("occupancy", []):
            self._occupancy.setdefault(int(tid), {})[zn] = float(t)
        self._cooldown = {(int(tid), zn): float(t) for tid, zn, t in d.get("cooldown", [])}
        for zn, c in d.get("counts", {}).items():
            if zn in self._counts:
                self._counts[zn] = {"entries": int(c["entries"]), "tids": set(c["tids"])}
        self._last_wall_chunk = d.get("last_wall_chunk")
        h = d.get("hist")
        if h is not None:
            self._hist = np.asarray(h["pts"], np.float64)
            self._hist_len = np.asarray(h["len"], np.int32)
            self._hist_tid = np.asarray(h["tid"], np.int64)

    def process(self, tracks: Sequence, frame_id: int,
                timestamp: float | None = None,
                inside_mat: np.ndarray | None = None) -> list[ZoneEvent]:
        """Check all tracks against all zones; emit + persist new events.

        ``timestamp`` is the stream time of this frame (seconds).  With
        ``clock: stream`` it drives dwell/cooldown; omitted or with
        ``clock: wall``, wall time is used (reference behavior).

        ``inside_mat`` (len(tracks), len(zones)) bool may be supplied when
        containment was already computed elsewhere; the engine then does only
        dwell/cooldown bookkeeping and serialization.
        """
        now = time.time() if (self.clock == "wall" or timestamp is None) else timestamp
        events: list[ZoneEvent] = []
        tracks = list(tracks)

        if inside_mat is None:
            if tracks and self.zones:
                cents = np.array(
                    [[(t.xyxy[0] + t.xyxy[2]) / 2, (t.xyxy[1] + t.xyxy[3]) / 2]
                     for t in tracks],
                    dtype=np.float64,
                )
                inside_mat = _points_in_polygons_np(
                    cents, [z.polygon for z in self.zones])
            else:
                inside_mat = np.zeros((len(tracks), len(self.zones)), bool)

        active_ids: set[int] = set()
        for ti, track in enumerate(tracks):
            active_ids.add(track.track_id)
            cx = int((track.xyxy[0] + track.xyxy[2]) / 2)
            cy = int((track.xyxy[1] + track.xyxy[3]) / 2)
            for zi, zone in enumerate(self.zones):
                if zone.classes is not None and int(track.class_id) not in zone.classes:
                    continue
                if zone.trigger == "crossing":
                    # entry event gated on motion direction (the reference
                    # declares `direction` but never implements it)
                    key = (track.track_id, zone.name)
                    was_inside = self._occupancy.get(track.track_id, {}).get(zone.name)
                    if inside_mat[ti, zi]:
                        occ = self._occupancy.setdefault(track.track_id, {})
                        if was_inside is None:
                            self._count_entry(zone.name, track.track_id)
                        occ.setdefault(zone.name, now)
                        if was_inside is None and self._direction_ok(zone, track):
                            if now - self._cooldown.get(key, -1e18) >= zone.cooldown_sec:
                                evt = ZoneEvent(
                                    timestamp_utc=time.strftime(
                                        "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                                    event_type="crossing",
                                    zone_name=zone.name,
                                    track_id=track.track_id,
                                    class_id=int(track.class_id),
                                    class_name=getattr(track, "class_name", ""),
                                    dwell_time_sec=0.0,
                                    bbox_xyxy=[float(v) for v in track.xyxy],
                                    centroid=[cx, cy],
                                    frame_id=frame_id,
                                    metadata={**self.extra_metadata,
                                              "direction": zone.direction or "any"},
                                )
                                events.append(evt)
                                self._cooldown[key] = now
                                self._emit(evt)
                    else:
                        if track.track_id in self._occupancy:
                            self._occupancy[track.track_id].pop(zone.name, None)
                    continue
                if inside_mat[ti, zi]:
                    occ = self._occupancy.setdefault(track.track_id, {})
                    if zone.name not in occ:
                        self._count_entry(zone.name, track.track_id)
                    occ.setdefault(zone.name, now)
                    dwell = now - occ[zone.name]
                    if dwell >= zone.dwell_time_sec:
                        key = (track.track_id, zone.name)
                        if now - self._cooldown.get(key, -1e18) >= zone.cooldown_sec:
                            evt = ZoneEvent(
                                timestamp_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                                event_type=zone.trigger,
                                zone_name=zone.name,
                                track_id=track.track_id,
                                class_id=int(track.class_id),
                                class_name=getattr(track, "class_name", ""),
                                dwell_time_sec=round(dwell, 2),
                                bbox_xyxy=[float(v) for v in track.xyxy],
                                centroid=[cx, cy],
                                frame_id=frame_id,
                                metadata=dict(self.extra_metadata),
                            )
                            events.append(evt)
                            self._cooldown[key] = now
                            self._emit(evt)
                else:
                    if track.track_id in self._occupancy:
                        self._occupancy[track.track_id].pop(zone.name, None)

        # purge state of vanished tracks (reference zone_engine.py:127-130)
        for sid in set(self._occupancy) - active_ids:
            del self._occupancy[sid]
        if now is not None:
            self._prune_cooldown(float(now))
        return events

    # ------------------------------------------------------------------
    def process_chunk(
        self,
        track_ids: np.ndarray,        # (K, S) int
        class_ids: np.ndarray,        # (K, S) int
        boxes: np.ndarray,            # (K, S, 4) float xyxy
        visible: np.ndarray,          # (K, S) bool
        frame_ids: Sequence[int],
        timestamps: Sequence[float] | None = None,
        inside: np.ndarray | None = None,   # (K, S, Z) bool (device masks)
        class_names: Sequence[str] | None = None,
    ) -> list[ZoneEvent]:
        """Vectorized equivalent of K sequential ``process`` calls, operating
        directly on the chunked tracker outputs (no host Track objects).

        The dwell state machine runs as array ops over the whole (K, S) chunk:
        containment for every (frame, slot, zone) in one pass, zone-entry
        edges and per-run entry timestamps via a prefix-max over the frame
        axis, and only the (rare) frames that actually trigger drop into
        Python for cooldown bookkeeping and serialization.  Semantically
        identical to the per-frame path (see test_evaluation's equivalence
        test); this is what the chunked pipeline and the multi-stream consume
        call - it cuts host consume from ~107 us/frame to a few us/frame.
        """
        k = int(track_ids.shape[0])
        if k == 0 or not self.zones:
            return []
        if timestamps is None or self.clock == "wall":
            # wall clock per chunk: the K frames arrived spread over the
            # interval since the previous chunk, so interpolate per-frame
            # wall offsets across it (a single time.time() for all K would
            # quantize dwell/cooldown to chunk-sized steps, diverging from
            # the per-frame reference-compat path); the first chunk has no
            # interval yet and stamps all K frames with one reading
            now = time.time()
            prev = self._last_wall_chunk
            if prev is not None and now > prev:
                ts = prev + (np.arange(1, k + 1, dtype=np.float64) / k) * (now - prev)
            else:
                ts = np.full((k,), now, np.float64)
            self._last_wall_chunk = now
        else:
            ts = np.asarray(timestamps, np.float64)
        visible = np.asarray(visible, bool)
        track_ids = np.asarray(track_ids)

        # compact to slots that are occupied at least once this chunk - the
        # tracker's slot array is mostly empty (max_tracks >> live tracks)
        n_slots = int(visible.shape[1])
        active = np.where(visible.any(axis=0))[0]
        if len(active) == 0:
            self._occupancy.clear()
            return []
        visible = visible[:, active]
        track_ids = track_ids[:, active]
        class_ids = np.asarray(class_ids)[:, active]
        boxes = np.asarray(boxes)[:, active]
        cents = (boxes[..., 0:2] + boxes[..., 2:4]) * 0.5    # (K, A, 2)

        if inside is None:
            # containment only at (frame, slot) positions that hold a track
            fi, si = np.where(visible)
            ins_pts = _points_in_polygons_np(
                cents[fi, si].astype(np.float64),
                [z.polygon for z in self.zones])
            inside = np.zeros((k, len(active), len(self.zones)), bool)
            inside[fi, si] = ins_pts
        else:
            inside = np.asarray(inside, bool)[:, active]

        # same-tid continuity between consecutive frames (a slot re-used by a
        # new track breaks the run, so dwell restarts - per-frame semantics)
        same_tid = np.zeros_like(visible)
        same_tid[1:] = track_ids[1:] == track_ids[:-1]
        f_idx = np.arange(k)[:, None]
        events: list[ZoneEvent] = []

        vis0 = np.where(visible[0])[0]
        for zi, zone in enumerate(self.zones):
            class_ok = (np.ones(visible.shape, bool) if zone.classes is None
                        else np.isin(class_ids, np.asarray(zone.classes)))
            m = visible & inside[:, :, zi] & class_ok
            had_inside = bool(m.any())
            if not had_inside:
                # still sync occupancy below: a track that left this zone
                # during an all-outside chunk must not keep a stale entry
                # (its dwell would otherwise resume with inflated time)
                entry_ts = None
                self._sync_zone_occupancy(zone, m, class_ok, visible,
                                          track_ids, entry_ts)
                continue
            # carried-in runs: tracks already inside this zone before the chunk
            prev = np.zeros_like(m)
            prev[1:] = m[:-1] & same_tid[1:]
            carried_entry = np.zeros((m.shape[1],), np.float64)
            for s in vis0:
                if not m[0, s]:
                    continue
                e = self._occupancy.get(int(track_ids[0, s]), {}).get(zone.name)
                if e is not None:
                    prev[0, s] = True
                    carried_entry[s] = e
            start = m & ~prev
            for f, s in np.argwhere(start):   # zone analytics (entry edges)
                self._count_entry(zone.name, int(track_ids[f, s]))
            # per-run entry timestamp: prefix-max of start frame indices
            last_start = np.maximum.accumulate(np.where(start, f_idx, -1), axis=0)
            entry_ts = np.where(last_start >= 0,
                                ts[np.clip(last_start, 0, None)],
                                carried_entry[None, :])
            if zone.trigger == "crossing":
                cand = start
                dwell = np.zeros_like(entry_ts)
            else:
                dwell = ts[:, None] - entry_ts
                cand = m & (dwell >= zone.dwell_time_sec)
            for f, s in np.argwhere(cand):
                tid = int(track_ids[f, s])
                now = float(ts[f])
                if zone.trigger == "crossing" and not self._direction_ok_arrays(
                        zone, f, s, tid, cents, visible, track_ids,
                        int(active[s])):
                    continue
                key = (tid, zone.name)
                if now - self._cooldown.get(key, -1e18) < zone.cooldown_sec:
                    continue
                cid = int(class_ids[f, s])
                evt = ZoneEvent(
                    timestamp_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                    event_type=zone.trigger,
                    zone_name=zone.name,
                    track_id=tid,
                    class_id=cid,
                    class_name=(class_names[cid]
                                if class_names is not None
                                and 0 <= cid < len(class_names) else ""),
                    dwell_time_sec=(0.0 if zone.trigger == "crossing"
                                    else round(float(dwell[f, s]), 2)),
                    bbox_xyxy=[float(v) for v in boxes[f, s]],
                    centroid=[int(cents[f, s, 0]), int(cents[f, s, 1])],
                    frame_id=int(frame_ids[f]),
                    metadata=({**self.extra_metadata,
                               "direction": zone.direction or "any"}
                              if zone.trigger == "crossing"
                              else dict(self.extra_metadata)),
                )
                events.append(evt)
                self._cooldown[key] = now
                self._emit(evt)
            # end-of-chunk occupancy sync for this zone (final-frame state)
            self._sync_zone_occupancy(zone, m, class_ok, visible, track_ids,
                                      entry_ts)

        # purge state of tracks not active at the chunk's final frame
        final_ids = {int(t) for t in track_ids[-1][visible[-1]]}
        for sid in set(self._occupancy) - final_ids:
            del self._occupancy[sid]
        self._prune_cooldown(float(ts[-1]))
        if any(z.trigger == "crossing" and z.direction for z in self.zones):
            self._update_hist(cents, visible, track_ids, active, n_slots)
        return events

    def _sync_zone_occupancy(self, zone, m, class_ok, visible, track_ids,
                             entry_ts) -> None:
        """Final-frame occupancy sync for one zone, mirroring per-frame
        semantics: inside tracks keep/refresh their entry time; outside
        tracks reset dwell; class-filtered tracks KEEP their entry (the
        per-frame path skips them before the inside test)."""
        for s in np.where(visible[-1])[0]:
            tid = int(track_ids[-1, s])
            if entry_ts is not None and m[-1, s]:
                self._occupancy.setdefault(tid, {})[zone.name] = float(
                    entry_ts[-1, s])
            elif class_ok[-1, s] and tid in self._occupancy:
                self._occupancy[tid].pop(zone.name, None)

    def _count_entry(self, zone_name: str, track_id: int) -> None:
        c = self._counts[zone_name]
        c["entries"] += 1
        c["tids"].add(int(track_id))

    def zone_counts(self) -> dict[str, dict[str, int]]:
        """Per-zone analytics (framework extension): cumulative entry
        transitions, distinct track ids ever entered, and the number of
        tracks currently inside.  Identical between the per-frame and
        chunked paths (each entry edge counts once)."""
        out = {}
        for z in self.zones:
            c = self._counts[z.name]
            current = sum(1 for occ in self._occupancy.values()
                          if z.name in occ)
            out[z.name] = {"entries": c["entries"],
                           "unique_tracks": len(c["tids"]),
                           "current": current}
        return out

    def _prune_cooldown(self, now: float) -> None:
        """Drop cooldown entries already past their zone's window - they can
        never suppress again (the check passes regardless), but on 24/7
        streams with ever-fresh track ids they accumulate without bound."""
        if len(self._cooldown) <= 4096:
            return
        window = {z.name: float(z.cooldown_sec) for z in self.zones}
        self._cooldown = {k: v for k, v in self._cooldown.items()
                          if now - v < window.get(k[1], 0.0)}

    def _direction_ok_arrays(self, zone: Zone, f: int, s: int, tid: int,
                             cents: np.ndarray, visible: np.ndarray,
                             track_ids: np.ndarray, slot: int) -> bool:
        """Motion-direction gate from the slot's centroid history: carried
        per-slot trail + this chunk's visible centroids up to frame ``f``
        (same window semantics as ``Track.trail``).  ``s`` indexes the
        compacted chunk arrays; ``slot`` is the tracker's real slot index
        keying the persistent history ring."""
        if not zone.direction:
            return True
        sel = visible[:f + 1, s] & (track_ids[:f + 1, s] == tid)
        pts = cents[:f + 1, s][sel]
        if (self._hist is not None and slot < self._hist.shape[0]
                and self._hist_tid[slot] == tid and self._hist_len[slot] > 0):
            pts = np.concatenate([self._hist[slot, :self._hist_len[slot]], pts])
        pts = np.trunc(pts[-self._trail_maxlen:])  # int-truncate like
        # Track.trail so both paths give one verdict on sub-pixel motion
        if len(pts) < 2:
            return False
        dx = pts[-1, 0] - pts[0, 0]
        dy = pts[-1, 1] - pts[0, 1]
        return {
            "left_to_right": dx > 0,
            "right_to_left": dx < 0,
            "top_to_bottom": dy > 0,
            "bottom_to_top": dy < 0,
        }.get(zone.direction, True)

    def _update_hist(self, cents: np.ndarray, visible: np.ndarray,
                     track_ids: np.ndarray, active: np.ndarray,
                     n_slots: int) -> None:
        """Roll the per-slot centroid ring forward by one chunk.  The chunk
        arrays are compacted to ``active`` slots; the ring is keyed by the
        tracker's full slot index so identity persists across chunks."""
        lmax = self._trail_maxlen
        if self._hist is None or self._hist.shape[0] != n_slots:
            self._hist = np.zeros((n_slots, lmax, 2), np.float64)
            self._hist_len = np.zeros((n_slots,), np.int32)
            self._hist_tid = np.full((n_slots,), -1, np.int64)
        for s, slot in enumerate(active):
            vf = np.where(visible[:, s])[0]
            if len(vf) == 0:
                continue
            tid = int(track_ids[vf[-1], s])
            run = cents[vf[(track_ids[vf, s] == tid)], s]
            if self._hist_tid[slot] == tid and self._hist_len[slot] > 0:
                run = np.concatenate([self._hist[slot, :self._hist_len[slot]], run])
            run = run[-lmax:]
            self._hist[slot, :len(run)] = run
            self._hist_len[slot] = len(run)
            self._hist_tid[slot] = tid

    def get_zone_polygons(self) -> list[tuple[str, np.ndarray]]:
        """For the visualization overlay (reference zone_engine.py:134-136)."""
        return [(z.name, z.polygon.astype(np.int32)) for z in self.zones]

    # ------------------------------------------------------------------
    @staticmethod
    def _direction_ok(zone: Zone, track) -> bool:
        """Motion-direction gate for crossing zones, from the track's trail."""
        if not zone.direction:
            return True
        trail = getattr(track, "trail", None)
        if not trail or len(trail) < 2:
            return False
        dx = trail[-1][0] - trail[0][0]
        dy = trail[-1][1] - trail[0][1]
        return {
            "left_to_right": dx > 0,
            "right_to_left": dx < 0,
            "top_to_bottom": dy > 0,
            "bottom_to_top": dy < 0,
        }.get(zone.direction, True)

    @staticmethod
    def _parse_zone(cfg: ZoneConfig | dict) -> Zone:
        if isinstance(cfg, dict):
            cfg = ZoneConfig(**cfg)
        return Zone(
            name=cfg.name,
            polygon=np.asarray(cfg.polygon, dtype=np.float32),
            trigger=cfg.trigger,
            dwell_time_sec=cfg.dwell_time_sec,
            cooldown_sec=cfg.cooldown_sec,
            direction=cfg.direction,
            classes=cfg.classes,
        )

    def _emit(self, evt: ZoneEvent) -> None:
        backend = self.alert.backend
        with open(self.log_path, "a") as f:
            f.write(evt.to_json() + "\n")
        if backend == "webhook" and self.alert.webhook_url:
            self._post_webhook(evt)
        logger.info(f"EVENT | {evt.event_type} | zone={evt.zone_name} "
                    f"track={evt.track_id} dwell={evt.dwell_time_sec:.1f}s")

    def _post_webhook(self, evt: ZoneEvent) -> None:
        import urllib.request

        try:
            req = urllib.request.Request(
                self.alert.webhook_url,
                data=evt.to_json().encode(),
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=2.0)
        except Exception as e:
            logger.warning(f"webhook alert failed: {e}")
