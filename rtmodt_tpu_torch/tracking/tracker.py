"""Public tracker facade: ``MultiObjectTracker`` + ``Track``.

The port's copy of ``rtmodt_tpu/tracking/tracker.py``: the same constructor
dispatch over ``bytetrack`` / ``ocsort`` / ``deepsort`` / ``botsort``, the
same ``update(detections, frame) -> list[Track]`` call (with the
reference's power-of-two padding of the detections), the same conversions
of a step's ``TrackOutputs`` into host ``Track`` lists, and the same per-id
centroid trails capped at ``trail_length`` and pruned of ids long gone.

  * ``bytetrack`` with ``assignment: greedy``, ``ocsort``, ``deepsort`` and
    ``botsort`` keep their fixed-slot state on the tracker's device;
    ``deepsort`` and ``botsort`` embed ROI crops of the frame
    (``embed_fn``, ``models/embedder.py``);
  * ``bytetrack`` with ``assignment: lapjv`` is the host NumPy tracker with
    the optimal C++ solver (``host_bytetrack.py``);
  * ``tracking.gmc.method: phase`` shifts the device state by the camera
    motion estimated from consecutive frames before each update.

``state_arrays`` / ``load_state_arrays`` (and ``save_state`` / ``load_state``
on an ``.npz``) move the device state and the trails to and from host numpy
arrays under the reference's field names and dtypes, so a snapshot of either
package loads into the other (``runtime/state_store.py``).

``step_chunk`` runs a chunk's T ByteTrack steps as one CUDA-graph replay
(``tracking/chunk_graph.py``; ``Pipeline.track_chunk`` decides when); after
it ``state`` is the graph's static state, which the next replay updates in
place.  Plain counts: ``graph_captures``, ``graph_replays`` and
``eager_chunks`` (reason -> chunks that ``track_chunk`` ran step by step).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path

import numpy as np
import torch

from rtmodt_tpu_torch.config.loader import (BotSortConfig, ByteTrackConfig, DeepSortConfig,
                                            GMCConfig, OCSortConfig)
from rtmodt_tpu_torch.device import resolve_device
from rtmodt_tpu_torch.tracking.bytetrack import (TrackOutputs, bytetrack_update,
                                                 init_track_state)
from rtmodt_tpu_torch.tracking.chunk_graph import ChunkGraphs
from rtmodt_tpu_torch.utils.logging import logger

SHIPPED_EMBEDDER = Path(__file__).resolve().parents[2] / "checkpoints" / "embedder.npz"


def _as_cfg(cls, value):
    """A config dataclass from a dataclass or a dict (unknown keys dropped)."""
    if isinstance(value, cls):
        return value
    known = cls.__dataclass_fields__
    return cls(**{k: v for k, v in (value or {}).items() if k in known})


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
    """The four trackers behind the reference's facade, their device state
    on ``device`` (default ``"cuda"``)."""

    def __init__(self, algorithm: str = "bytetrack", trail_length: int = 30,
                 device: str | torch.device = "cuda", **kwargs):
        self.algorithm = algorithm.lower()
        if self.algorithm not in ("bytetrack", "deepsort", "botsort", "ocsort"):
            raise ValueError(f"Unknown tracker: {self.algorithm}")
        self.device = resolve_device(device)

        self._trail_map: dict[int, list[tuple[int, int]]] = defaultdict(list)
        self._trail_maxlen = trail_length
        # trail garbage collection: ids absent long past any possible
        # re-match are dropped so 24/7 streams don't accumulate a graveyard
        self._frame_count = 0
        self._trail_seen: dict[int, int] = {}
        self._host = None
        self._embed_fns: dict = {}
        self._graphs = None
        self.graph_captures = 0
        self.graph_replays = 0
        self.eager_chunks: dict[str, int] = {}
        self._setup_gmc(kwargs.get("gmc"))

        if self.algorithm in ("deepsort", "botsort"):
            from rtmodt_tpu_torch.tracking.botsort import botsort_update
            from rtmodt_tpu_torch.tracking.deepsort import deepsort_update

            cfg_cls, update_fn = ((DeepSortConfig, deepsort_update)
                                  if self.algorithm == "deepsort"
                                  else (BotSortConfig, botsort_update))
            self.cfg = _as_cfg(cfg_cls, kwargs.get(self.algorithm, kwargs))
            self.embedder = self._load_embedder()
            self._update = partial(update_fn, cfg=self.cfg)
            logger.info(f"Tracker initialised: {self.algorithm} "
                        f"(embed_dim={self.cfg.embed_dim}) on {self.device}")
        elif self.algorithm == "ocsort":
            from rtmodt_tpu_torch.tracking.ocsort import ocsort_update

            self.cfg = _as_cfg(OCSortConfig, kwargs.get("ocsort", kwargs))
            self._update = partial(ocsort_update, cfg=self.cfg)
            logger.info(f"Tracker initialised: ocsort (min_hits={self.cfg.min_hits}, "
                        f"delta_t={self.cfg.delta_t}, use_byte={self.cfg.use_byte}) "
                        f"on {self.device}")
        else:
            self.cfg = _as_cfg(ByteTrackConfig, kwargs.get("bytetrack", kwargs))
            if self.cfg.assignment == "lapjv":
                from rtmodt_tpu_torch.tracking.host_bytetrack import HostByteTrack

                self._host = HostByteTrack(self.cfg)
            self._update = partial(bytetrack_update, cfg=self.cfg)
            logger.info(f"Tracker initialised: {self.algorithm} "
                        f"({self.cfg.assignment}/{self.cfg.motion_model}) on "
                        f"{'the host' if self._host is not None else self.device}")
        self.state = self._init_state()

    def _init_state(self):
        if self._host is not None:
            return None
        if self.algorithm in ("deepsort", "botsort"):
            from rtmodt_tpu_torch.tracking.deepsort import init_deepsort_state

            return init_deepsort_state(self.cfg.max_tracks, self.cfg.embed_dim, self.device)
        if self.algorithm == "ocsort":
            from rtmodt_tpu_torch.tracking.ocsort import init_ocsort_state

            return init_ocsort_state(self.cfg.max_tracks, self.cfg.delta_t, self.device)
        return init_track_state(self.cfg.max_tracks, self.device)

    def _load_embedder(self):
        """The reference's weights chain: an explicit path loads or raises;
        ``random`` / ``none`` mean seeded init; otherwise the shipped
        ``checkpoints/embedder.npz``, with a logged seeded init when it is
        absent or unusable."""
        from rtmodt_tpu_torch.models.embedder import init_embedder

        hw, dim = tuple(self.cfg.crop_hw), self.cfg.embed_dim
        weights = self.cfg.embedder
        if weights in ("random", "none"):
            return init_embedder(hw, dim, "", device=self.device)
        if weights:
            return init_embedder(hw, dim, weights, device=self.device)
        if not SHIPPED_EMBEDDER.exists():
            logger.warning(f"{self.algorithm}: {SHIPPED_EMBEDDER} not found; seeded "
                           "random embedder init")
            return init_embedder(hw, dim, "", device=self.device)
        try:
            model = init_embedder(hw, dim, str(SHIPPED_EMBEDDER), device=self.device)
        except (OSError, ValueError, KeyError) as e:
            logger.warning(f"shipped embedder weights unusable ({e}); seeded random "
                           "embedder init")
            return init_embedder(hw, dim, "", device=self.device)
        logger.info(f"{self.algorithm}: using shipped embedder weights {SHIPPED_EMBEDDER}")
        return model

    # -- camera motion compensation ------------------------------------------
    def _setup_gmc(self, gmc) -> None:
        """``tracking.gmc``: with ``method: phase``, ``update(detections,
        frame)`` estimates the scene translation against the previous frame
        (``ops/gmc.py``) and shifts the track state before association."""
        self.gmc_cfg = gmc if isinstance(gmc, GMCConfig) else _as_cfg(GMCConfig, gmc)
        self._gmc_prev = None
        if self.gmc_cfg.method != "none":
            logger.info(f"Tracker GMC enabled: phase correlation on a "
                        f"{self.gmc_cfg.grid}x{self.gmc_cfg.grid} luma grid")

    @torch.no_grad()
    def _gmc_apply(self, frame: np.ndarray) -> None:
        """Compensate the state for the camera motion since the previous
        frame (nothing on the first frame or after a reset)."""
        from rtmodt_tpu_torch.ops.gmc import compensate, luma_grid, phase_shift

        g = self.gmc_cfg
        cur = luma_grid(torch.as_tensor(frame).to(self.device), g.grid)
        if self._gmc_prev is not None:
            h, w = frame.shape[:2]
            shift, _ = phase_shift(self._gmc_prev, cur, g.min_ratio, g.max_shift_frac)
            scale = torch.tensor([w / g.grid, h / g.grid], dtype=torch.float32,
                                 device=self.device)
            self.state = compensate(self.state, shift * scale)
        self._gmc_prev = cur

    # -- appearance ------------------------------------------------------------
    def embed_fn(self, normalized: bool = False):
        """(image, boxes (D, 4)) -> (D, E) embeddings for deepsort/botsort.

        ``normalized=False``: image is the raw uint8 BGR frame (H, W, 3) on
        the device, boxes in its coordinates; ``normalized=True``: image is
        the letterboxed RGB in [0, 1].  The embedder takes RGB in [0, 255]."""
        if normalized in self._embed_fns:
            return self._embed_fns[normalized]
        from rtmodt_tpu_torch.ops.roi import crop_and_resize

        crop_hw = tuple(self.cfg.crop_hw)
        model = self.embedder

        @torch.no_grad()
        def fn(image: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
            crops = crop_and_resize(image, boxes, crop_hw)
            crops = crops * 255.0 if normalized else crops.flip(-1)
            return model(crops)

        self._embed_fns[normalized] = fn
        return fn

    def reset(self) -> None:
        self._trail_map.clear()
        self._gmc_prev = None
        if self._host is not None:
            self._host._tracks.clear()
            self._host._next_id = 1
        self.state = self._init_state()

    # -- state save / load (kill-and-resume, runtime/state_store.py) -------------
    def state_arrays(self) -> dict[str, np.ndarray]:
        """The tracker state as a flat dict of host numpy arrays: every field
        of the state tuple, ``trail_ids`` (N,) int64 and ``trail_data`` (N,
        trail_length, 2) int64 padded with (-1, -1)."""
        if self._host is not None:
            raise NotImplementedError("host-tracker state save not supported")
        out = {k: v.detach().cpu().numpy() for k, v in self.state._asdict().items()}
        n = len(self._trail_map)
        data = np.asarray([t + [(-1, -1)] * (self._trail_maxlen - len(t))
                           for t in self._trail_map.values()], np.int64)
        out["trail_ids"] = np.asarray(list(self._trail_map.keys()), np.int64)
        out["trail_data"] = data.reshape(n, self._trail_maxlen if n else 0, 2)
        return out

    def load_state_arrays(self, z) -> None:
        """Inverse of ``state_arrays``; ``z`` is any mapping of arrays (an open
        ``np.load`` handle or a dict).  Refuses a field whose shape or dtype
        differs from this tracker's (another ``max_tracks``, ``embed_dim`` or
        ``delta_t``) before changing anything."""
        if self._host is not None:
            raise NotImplementedError("host-tracker state load not supported")
        cur = self.state._asdict()
        fields = {}
        for k, t in cur.items():
            arr = np.asarray(z[k])
            want = (tuple(t.shape), t.cpu().numpy().dtype)
            if (arr.shape, arr.dtype) != want:
                raise ValueError(f"snapshot field {k!r} is {arr.shape}/{arr.dtype}; this "
                                 f"tracker expects {want[0]}/{want[1]} (max_tracks / "
                                 "embed_dim config mismatch?)")
            fields[k] = torch.from_numpy(arr.copy()).to(self.device)
        self.state = type(self.state)(**fields)
        self._trail_map.clear()
        self._trail_seen.clear()
        for tid, trail in zip(z["trail_ids"], z["trail_data"]):
            self._trail_map[int(tid)] = [(int(x), int(y)) for x, y in trail if x >= 0]
            self._trail_seen[int(tid)] = self._frame_count

    def save_state(self, path: str) -> None:
        np.savez(path, **self.state_arrays())

    def load_state(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state_arrays(z)

    @torch.no_grad()
    def step(self, boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
             valid: torch.Tensor, feats: torch.Tensor | None = None) -> TrackOutputs:
        """One device step on device detections (and, for deepsort/botsort,
        their (D, E) embeddings); returns the device outputs."""
        if self._host is not None:
            raise RuntimeError("assignment: lapjv tracks on the host; call update()")
        if self.algorithm in ("deepsort", "botsort"):
            if feats is None:
                raise ValueError(f"{self.algorithm} needs the detections' embeddings")
            self.state, outputs = self._update(self.state, boxes, scores, classes, valid,
                                               feats)
        else:
            self.state, outputs = self._update(self.state, boxes, scores, classes, valid)
        return outputs

    @torch.no_grad()
    def step_chunk(self, boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                   valid: torch.Tensor) -> TrackOutputs:
        """T ByteTrack (greedy) steps on device detections with T leading,
        as one CUDA-graph replay (captured on the first chunk of its shapes);
        outputs stacked (T, ...), fresh tensors."""
        if self.algorithm != "bytetrack" or self._host is not None:
            raise RuntimeError("step_chunk replays ByteTrack with greedy assignment only")
        if self._graphs is None:
            self._graphs = ChunkGraphs(self.cfg)
        self.state, outputs, captured = self._graphs.run(self.state,
                                                         (boxes, scores, classes, valid))
        self.graph_captures += captured
        self.graph_replays += 1
        return outputs

    def update(self, detections, frame: np.ndarray | None = None) -> list[Track]:
        """Reference-compatible API: Detections in, visible Track list out.
        ``frame`` (BGR uint8) is required for ``deepsort`` and ``botsort``
        (appearance embeddings of ROI crops) and feeds GMC when it is on."""
        names = getattr(detections, "class_names", [])
        if self._host is not None:
            raw = self._host.update(detections.xyxy, detections.confidence,
                                    detections.class_id)
            self._prune_trails()
            return [self._to_track(r, names) for r in raw]

        if self.gmc_cfg.method != "none" and frame is not None:
            self._gmc_apply(frame)

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
        dev = [torch.from_numpy(a).to(self.device) for a in (boxes, conf, cls, valid)]
        feats = None
        if self.algorithm in ("deepsort", "botsort"):
            if frame is None:
                raise ValueError(f"{self.algorithm} requires the frame for appearance "
                                 "embeddings: update(detections, frame)")
            feats = self.embed_fn()(torch.as_tensor(frame).to(self.device), dev[0])
        return self.tracks_from_outputs(self.step(*dev, feats=feats), names)

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
        buffer = getattr(self.cfg, "track_buffer", None) or getattr(self.cfg, "max_age", 30)
        horizon = max(600, 4 * int(buffer))
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
