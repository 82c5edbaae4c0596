"""Public tracker facade: ``MultiObjectTracker`` + ``Track``.

The port's copy of ``rtmodt_tpu/tracking/tracker.py`` for ByteTrack with
greedy assignment: the same ``update(detections) -> list[Track]`` call (with
the reference's power-of-two padding of the detections), the same
conversions of a step's ``TrackOutputs`` into host ``Track`` lists, and the
same per-id centroid trails capped at ``trail_length`` and pruned of ids
long gone.  The state lives on the tracker's device.

Not ported: the other algorithms (deepsort, botsort, ocsort) and GMC
(ROADMAP item 7), and ``assignment: lapjv`` (ROADMAP item 4).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from rtmodt_tpu_torch.config.loader import ByteTrackConfig
from rtmodt_tpu_torch.device import resolve_device
from rtmodt_tpu_torch.tracking.bytetrack import (TrackOutputs, TrackState,
                                                 bytetrack_update, init_track_state)
from rtmodt_tpu_torch.utils.logging import logger


@dataclass
class Track:
    """One tracked object (the reference's fields)."""

    track_id: int
    xyxy: np.ndarray               # (4,) float32
    confidence: float
    class_id: int
    class_name: str = ""
    age: int = 0
    time_since_update: int = 0
    trail: list[tuple[int, int]] = field(default_factory=list)


def _to_host(outputs: TrackOutputs) -> TrackOutputs:
    return TrackOutputs(*(np.asarray(t.cpu()) if isinstance(t, torch.Tensor)
                          else np.asarray(t) for t in outputs))


class MultiObjectTracker:
    """ByteTrack (greedy assignment) behind the reference's facade, on
    ``device`` (default ``"cuda"``)."""

    def __init__(self, algorithm: str = "bytetrack", trail_length: int = 30,
                 device: str | torch.device = "cuda", **kwargs):
        self.algorithm = algorithm.lower()
        if self.algorithm in ("deepsort", "botsort", "ocsort"):
            raise NotImplementedError(f"tracking.algorithm={self.algorithm!r} is not "
                                      "ported (ROADMAP item 7)")
        if self.algorithm != "bytetrack":
            raise ValueError(f"Unknown tracker: {self.algorithm}")
        gmc = kwargs.get("gmc")
        if gmc is not None and (gmc.get("method", "none") if isinstance(gmc, dict)
                                else getattr(gmc, "method", "none")) != "none":
            raise NotImplementedError("tracking.gmc is not ported (ROADMAP item 7)")
        self.device = resolve_device(device)

        self._trail_map: dict[int, list[tuple[int, int]]] = defaultdict(list)
        self._trail_maxlen = trail_length
        # trail garbage collection: ids absent long past any possible
        # re-match are dropped so 24/7 streams don't accumulate a graveyard
        self._frame_count = 0
        self._trail_seen: dict[int, int] = {}

        bt = kwargs.get("bytetrack", kwargs)
        if isinstance(bt, ByteTrackConfig):
            self.cfg = bt
        else:
            known = set(ByteTrackConfig.__dataclass_fields__)
            self.cfg = ByteTrackConfig(**{k: v for k, v in bt.items() if k in known})
        if self.cfg.assignment == "lapjv":
            raise NotImplementedError("tracking.bytetrack.assignment=lapjv is not "
                                      "ported (ROADMAP item 4)")
        self.state: TrackState = init_track_state(self.cfg.max_tracks, self.device)
        logger.info(f"Tracker initialised: {self.algorithm} "
                    f"({self.cfg.assignment}/{self.cfg.motion_model}) on {self.device}")

    def reset(self) -> None:
        self._trail_map.clear()
        self.state = init_track_state(self.cfg.max_tracks, self.device)

    @torch.no_grad()
    def step(self, boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
             valid: torch.Tensor) -> TrackOutputs:
        """One ByteTrack step on device detections; returns the device outputs."""
        self.state, outputs = bytetrack_update(self.state, boxes, scores, classes,
                                               valid, self.cfg)
        return outputs

    def update(self, detections, frame: np.ndarray | None = None) -> list[Track]:
        """Reference-compatible API: Detections in, visible Track list out
        (``frame`` is accepted for the reference's signature; ByteTrack does
        not read it)."""
        names = getattr(detections, "class_names", [])
        d = len(detections)
        # the reference pads to power-of-two buckets (min 8) so that XLA
        # compiles one program per bucket; the same padding here keeps the
        # slot assignment identical
        pad = max(8, 1 << (d - 1).bit_length()) if d else 8
        boxes = np.zeros((pad, 4), np.float32)
        conf = np.zeros((pad,), np.float32)
        cls = np.full((pad,), -1, np.int32)
        valid = np.zeros((pad,), bool)
        boxes[:d] = detections.xyxy
        conf[:d] = detections.confidence
        cls[:d] = detections.class_id
        valid[:d] = True
        outputs = self.step(*(torch.from_numpy(a).to(self.device)
                              for a in (boxes, conf, cls, valid)))
        return self.tracks_from_outputs(outputs, names)

    def tracks_chunk_from_outputs(self, outputs: TrackOutputs, names: list[str],
                                  with_indices: bool = False):
        """Host Track lists for a CHUNK of TrackOutputs (leading K axis): one
        visibility pass, Track objects only for visible slots.  With
        ``with_indices=True`` also returns each frame's slot indices in track
        order."""
        host = _to_host(outputs)
        out: list[list[Track]] = []
        indices: list[np.ndarray] = []
        for f in range(host.visible.shape[0]):
            idx = np.where(host.visible[f])[0]
            idx = idx[np.argsort(host.track_id[f, idx])] if len(idx) else idx
            frame_tracks = [self._to_track({
                "track_id": int(host.track_id[f, i]),
                "xyxy": host.boxes[f, i],
                "confidence": float(host.confidence[f, i]),
                "class_id": int(host.class_id[f, i]),
                "age": int(host.age[f, i]),
                "time_since_update": int(host.tsu[f, i]),
            }, names) for i in idx]
            out.append(frame_tracks)
            indices.append(idx)
            self._prune_trails()
        return (out, indices) if with_indices else out

    def tracks_from_outputs(self, outputs: TrackOutputs, names: list[str]) -> list[Track]:
        """Host Track objects of one step's TrackOutputs (device or host)."""
        host = _to_host(outputs)
        self._prune_trails()
        idx = np.where(host.visible)[0]
        out: list[Track] = []
        for i in idx[np.argsort(host.track_id[idx])] if len(idx) else []:
            out.append(self._to_track({
                "track_id": int(host.track_id[i]),
                "xyxy": np.asarray(host.boxes[i], np.float32),
                "confidence": float(host.confidence[i]),
                "class_id": int(host.class_id[i]),
                "age": int(host.age[i]),
                "time_since_update": int(host.tsu[i]),
            }, names))
        return out

    def _prune_trails(self) -> None:
        """Drop trails of ids unseen for far longer than any re-match window."""
        self._frame_count += 1
        if self._frame_count % 512:
            return
        horizon = max(600, 4 * int(self.cfg.track_buffer))
        dead = [tid for tid, seen in self._trail_seen.items()
                if self._frame_count - seen > horizon]
        for tid in dead:
            self._trail_seen.pop(tid, None)
            self._trail_map.pop(tid, None)

    def _to_track(self, r: dict, names: list[str]) -> Track:
        tid = r["track_id"]
        self._trail_seen[tid] = self._frame_count
        cx = int((r["xyxy"][0] + r["xyxy"][2]) / 2)
        cy = int((r["xyxy"][1] + r["xyxy"][3]) / 2)
        trail = self._trail_map[tid]
        trail.append((cx, cy))
        if len(trail) > self._trail_maxlen:
            trail.pop(0)
        cid = r["class_id"]
        return Track(
            track_id=tid,
            xyxy=np.asarray(r["xyxy"], np.float32),
            confidence=r["confidence"],
            class_id=cid,
            class_name=names[cid] if 0 <= cid < len(names) else "",
            age=r["age"],
            time_since_update=r["time_since_update"],
            trail=list(trail),
        )
