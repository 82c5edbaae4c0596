"""S camera streams over a mesh of cards (port of ``rtmodt_tpu/parallel/multistream.py``).

The reference runs S streams as one SPMD program, the stream axis sharded
over a TPU mesh.  The port runs one process per card (``parallel/mesh.py``):
rank r of N takes streams ``[r * S / N, (r + 1) * S / N)`` on its own card,
with no collective on the device path (the streams are independent), and
runs them as one batch: the detector forward once over all its S / N (or
T * S / N) frames of a call, NMS (the CUDA kernel K1) once over those
frames, and the tracker T times in order, each update over all its streams
at once.  Without a mesh, inside a rank the default is the ranks' mesh when
it divides S (this rank's card otherwise), and outside one it is this
process's device.  Layouts (the inputs carry every stream, or this rank's;
the outputs are this rank's streams):

  * ``step(frames (S, H, W, 3))``          - one BGR frame per stream;
  * ``step_chunk(frames (T, S, H, W, 3))`` - T frames per stream, BGR;
  * ``submit_chunk_packed((y, u, v) (T, S, ...), src_h, src_w)`` - planar
    I420 chunks, the program ``run`` drives; or one pre-packed x6 / x24
    array (T, S, ...) that the device unpacks to planes.

Trackers: ByteTrack (greedy assignment) keeps one S-leading state and
updates every stream in one batched call (``tracking/bytetrack.py``); OC-SORT,
DeepSORT and BoT-SORT keep one state per stream and run their single-stream
update on each (their batched forms are ROADMAP work).  With GMC on, each
stream carries its own previous luma grid and validity flag (``ops/gmc.py``).
``assignment: lapjv`` (a host tracker of one stream) is refused.

``run`` is the multi-camera loop: one reader + packer thread per stream,
time-aligned (T, S) chunks with ``pipeline_depth`` chunks in flight, one
``ZoneEventEngine`` per stream (its events carry ``{"stream": si}``, the
global index; every rank appends its streams' lines to the configured log,
one whole line per write), a degraded mode in which a stream that ends or
dies is fed blank frames, and an optional mosaic of the annotated streams:
each rank draws its own streams' tiles, rank 0 gathers them
(``gather_objects``, once a chunk), tiles them, and alone writes the video,
publishes to the MJPEG monitor and shows the window.  With ``state_path``
it writes kill-and-resume snapshots (``runtime/state_store.py``; rank 0 gathers every
stream's state into the one file) and resumes from one: each FILE source
drops the frames its stream already consumed.  Over several ranks the loop
makes one host all-reduce of a few integers per chunk (the chunk's real
frames, the resolution for a rank whose streams gave none yet, the display
window's quit, and with the mosaic on which of the chunk's rows hold a real
frame), so that every rank runs until every stream has ended, snapshots at
the same frames and draws the same rows, as one process would; the summary
is gathered to rank 0.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from rtmodt_tpu_torch.config.loader import PipelineConfig
from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine
from rtmodt_tpu_torch.ingestion.rtsp_reader import RTSPReader
from rtmodt_tpu_torch.ops.gmc import init_carry
from rtmodt_tpu_torch.ops.nms import NMSResult
from rtmodt_tpu_torch.ops.yuv import content_dims, pack_chunk, pack_i420_planar
from rtmodt_tpu_torch.parallel.mesh import (ENV_DEVICES, Mesh, create_mesh, gather_objects,
                                            local_mesh, sum_ints)
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.tracking.bytetrack import TrackOutputs, TrackState, init_track_state
from rtmodt_tpu_torch.tracking.chunk_graph import clone_state
from rtmodt_tpu_torch.utils.logging import logger


def init_multistream_state(num_streams: int, max_tracks: int,
                           device: str | torch.device = "cpu") -> TrackState:
    """ByteTrack's state with a leading stream axis: every tensor of
    ``init_track_state`` repeated ``num_streams`` times (``next_id`` (S,))."""
    one = init_track_state(max_tracks, device)
    return TrackState(*(t.expand(num_streams, *t.shape).clone() for t in one))


class MosaicAnnotator:
    """Host-side annotated output of the multi-camera mode: each stream's
    tracks drawn on its BGR frame (the single-stream ``FrameRenderer``) and
    the S streams tiled into one mosaic frame for ``--display`` /
    ``--save-video`` / the MJPEG monitor (``visualization.mjpeg_port``).
    Track ids are per stream, so are the centroid trails; a dead or short
    slot gets a black tile.  ``visualization.enabled:
    false`` still tiles the raw streams, without drawing.  ``streams`` are
    the global indices of the streams this process draws (default all of
    them); over several ranks each rank draws its own (``tiles``) and rank 0
    tiles every rank's (``grid``)."""

    def __init__(self, vcfg, names: list[str], num_streams: int,
                 streams: range | None = None):
        from rtmodt_tpu_torch.visualization.renderer import FrameRenderer

        self.annotate = vcfg.enabled
        # the per-tile label is the stream's name; the aggregate fps goes on
        # the mosaic itself
        self.renderer = FrameRenderer(
            show_boxes=vcfg.show_boxes, show_labels=vcfg.show_labels,
            show_trails=vcfg.show_trails, show_zones=vcfg.show_zones, show_hud=False)
        self.show_hud = vcfg.show_hud and vcfg.enabled
        self.names = names
        self.s = num_streams
        self.streams = range(num_streams) if streams is None else streams
        self.cols = int(np.ceil(np.sqrt(num_streams)))
        self.rows = int(np.ceil(num_streams / self.cols))
        self.trail_len = vcfg.trail_length
        drawn = len(self.streams)
        self._trails: list[dict[int, list[tuple[int, int]]]] = [{} for _ in range(drawn)]
        # ids unseen far past any re-match window are dropped (the facade's
        # policy), so 24/7 runs keep no graveyard of trails
        self._frame_count = [0] * drawn
        self._trail_seen: list[dict[int, int]] = [{} for _ in range(drawn)]

    def _prune_trails(self, si: int) -> None:
        self._frame_count[si] += 1
        if self._frame_count[si] % 512:
            return
        horizon = max(600, 4 * self.trail_len)
        seen = self._trail_seen[si]
        for tid in [t for t, last in seen.items() if self._frame_count[si] - last > horizon]:
            seen.pop(tid, None)
            self._trails[si].pop(tid, None)

    def tracks_for(self, host: TrackOutputs, t: int, si: int) -> list:
        """Host TrackOutputs (T, S, N, ...) of the drawn streams -> the
        visible Tracks of frame t of drawn stream si, with their trails."""
        from rtmodt_tpu_torch.tracking.tracker import Track

        trails = self._trails[si]
        self._prune_trails(si)
        out = []
        for i in np.where(np.asarray(host.visible[t, si]))[0]:
            tid = int(host.track_id[t, si, i])
            self._trail_seen[si][tid] = self._frame_count[si]
            box = np.asarray(host.boxes[t, si, i], np.float32)
            trail = trails.setdefault(tid, [])
            trail.append((int((box[0] + box[2]) / 2), int((box[1] + box[3]) / 2)))
            del trail[:max(0, len(trail) - self.trail_len)]
            cid = int(host.class_id[t, si, i])
            name = self.names[cid] if 0 <= cid < len(self.names) else str(cid)
            out.append(Track(
                track_id=tid, xyxy=box, confidence=float(host.confidence[t, si, i]),
                class_id=cid, class_name=name,
                age=int(host.age[t, si, i]), time_since_update=int(host.tsu[t, si, i]),
                trail=list(trail)))
        return out

    def tiles(self, host: TrackOutputs, t: int, bgr_row: list, zones,
              shape: tuple[int, ...]) -> list[np.ndarray]:
        """Frame t of a chunk, the drawn streams' tiles: each stream's tracks
        drawn on its frame (a black tile of ``shape`` for a dead slot,
        ``None`` in ``bgr_row``) with its global stream label."""
        import cv2

        tiles = []
        for si, f in enumerate(bgr_row):
            f = np.zeros(shape, np.uint8) if f is None else f
            if self.annotate:
                self.renderer.render(f, self.tracks_for(host, t, si), zones)
                cv2.putText(f, f"cam{self.streams[si]}", (8, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                            (80, 220, 80), 2, cv2.LINE_AA)
            tiles.append(f)
        return tiles

    def grid(self, tiles: list[np.ndarray], fps: float) -> np.ndarray:
        """Every stream's tile, in stream order, tiled into one (rows * H,
        cols * W) BGR frame with an aggregate-fps HUD."""
        import cv2

        tiles = tiles + [np.zeros_like(tiles[0])] * (self.rows * self.cols - self.s)
        grid = np.vstack([np.hstack(tiles[r * self.cols:(r + 1) * self.cols])
                          for r in range(self.rows)])
        if self.show_hud and fps > 0:
            cv2.putText(grid, f"{fps:.1f} FPS aggregate", (8, grid.shape[0] - 12),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2, cv2.LINE_AA)
        return grid

    def mosaic(self, host: TrackOutputs, t: int, bgr_row: list, zones, fps: float) -> np.ndarray:
        """Frame t of a chunk in one process that draws every stream: its
        tiles (a black tile for a dead slot, ``None`` in ``bgr_row``) tiled
        into one frame with per-tile stream labels and an aggregate-fps HUD."""
        shape = next(f.shape for f in bgr_row if f is not None)
        return self.grid(self.tiles(host, t, bgr_row, zones, shape), fps)


def _split_ts(x: torch.Tensor, t: int, s: int) -> torch.Tensor:
    return x.reshape(t, s, *x.shape[1:])


def stream_devices(num_streams: int, device: str = "cuda") -> list[str]:
    """The devices S streams run on, one rank each: those
    ``RTMODT_MESH_DEVICES`` names where it is set (``cpu,cpu``; ``cuda:0,cuda:0``
    for two ranks sharing one card); else every visible card where their
    count divides S, one card otherwise (the reference's default mesh); the
    CPU is one device."""
    from rtmodt_tpu_torch.device import resolve_device

    if os.environ.get(ENV_DEVICES):
        return os.environ[ENV_DEVICES].split(",")
    if resolve_device(device).type == "cpu":
        return ["cpu"]
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n if num_streams % n == 0 else 1)]


def _default_mesh(num_streams: int) -> Mesh | None:
    """Inside a rank: the ranks' mesh where it divides the streams, this
    rank's own card otherwise.  Outside one: None (this process's device)."""
    if os.environ.get(ENV_DEVICES) is None or not torch.distributed.is_initialized():
        return None
    mesh = create_mesh()
    return mesh if num_streams % mesh.world == 0 else create_mesh(1)


class MultiStreamPipeline:
    """S streams; this process takes its rank's S / N of them as one batch
    on its device.  ``mesh`` (``parallel/mesh.py``) places the streams; a
    mesh that does not divide S raises.  Without one, ``device`` wins over
    ``system.device`` (the card by default; ``"cpu"`` runs on the CPU);
    ``num_streams`` wins over ``parallel.num_streams``."""

    def __init__(self, cfg: PipelineConfig, num_streams: int | None = None,
                 device: str | None = None, seed: int = 0, mesh: Mesh | None = None):
        t = cfg.tracking
        if t.algorithm == "bytetrack" and t.bytetrack.assignment == "lapjv":
            raise ValueError("tracking.bytetrack.assignment=lapjv tracks one stream on the "
                             "host; the multi-stream pipeline runs the device tracker "
                             "(assignment: greedy)")
        self.cfg = cfg
        self.num_streams = num_streams or cfg.parallel.num_streams
        mesh = mesh or _default_mesh(self.num_streams)
        if mesh is not None:
            if self.num_streams % mesh.world:
                raise ValueError(f"num_streams={self.num_streams} must be divisible by mesh "
                                 f"size {mesh.world}")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device!r} is not the mesh's {mesh.device}")
            device = str(mesh.device)
        # the single-stream pipeline's detector, tracker facade and chunk
        # stages; the per-stream state lives here and is handed to it
        self._pipe = Pipeline(cfg, device=device, seed=seed)
        self.device = self._pipe.device
        self.mesh = mesh or local_mesh(self.device)
        # this rank's streams: [stream_offset, stream_offset + local_streams)
        self.stream_slice = self.mesh.shard(self.num_streams)
        self.local_streams = self.num_streams // self.mesh.world
        self.stream_offset = self.stream_slice.start
        self.detector = self._pipe.detector
        self.tracker = self._pipe.tracker
        self._batched = self.tracker.algorithm == "bytetrack"
        self._is_appearance = self.tracker.algorithm in ("deepsort", "botsort")
        self._gmc_on = t.gmc.method == "phase"
        self.chunks_submitted = 0
        self.reset()
        where = (f"streams {self.stream_offset}-{self.stream_slice.stop - 1} of "
                 f"{self.num_streams}, rank {self.mesh.rank} of {self.mesh.world}"
                 if self.mesh.world > 1 else f"{self.num_streams} streams")
        logger.info(f"multi-stream pipeline: {where} on {self.device} "
                    f"({self.tracker.algorithm}, "
                    f"{'batched' if self._batched else 'per-stream'} tracker)")

    def reset(self) -> None:
        """Fresh tracker state and GMC carry for every stream."""
        if self._batched:
            self.state = init_multistream_state(self.local_streams,
                                                self.tracker.cfg.max_tracks, device=self.device)
        else:
            self.state = [self.tracker._init_state() for _ in range(self.local_streams)]
        self._gmc_reset()

    def _gmc_reset(self) -> None:
        """Every stream's GMC carry back to a zero grid with valid = 0."""
        s, dev, g = self.local_streams, self.device, self.cfg.tracking.gmc.grid
        if self._batched:
            self._gmc_carry = init_carry(g, dev, s) if self._gmc_on else None
        else:
            self._gmc_carry = [init_carry(g, dev) if self._gmc_on else None for _ in range(s)]

    def warmup(self, shape_hw: tuple[int, int], chunk_size: int = 2) -> None:
        """One chunk of blank frames through the packed program (cuDNN picks
        its algorithms for the T * S batch), then the tracker state and the
        GMC carries it found are put back: no phantom tracks and no dummy
        GMC grid survive it, and a restored state does."""
        h, w = shape_hw
        # the per-stream trackers' lists are updated in place, and ByteTrack's
        # state may be a CUDA graph's, which a replay updates in place: keep copies
        found = (clone_state(self.state),
                 list(self._gmc_carry) if isinstance(self._gmc_carry, list) else self._gmc_carry)
        planes, _ = pack_chunk(np.zeros((1, h, w, 3), np.uint8), self.cfg.detection.input_size)
        t, s = max(1, chunk_size), self.local_streams
        self.submit_chunk_packed(tuple(np.ascontiguousarray(
            np.broadcast_to(p[:, None], (t, s, *p.shape[1:]))) for p in planes), h, w)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.state, self._gmc_carry = found

    # -- the tracker over T frames of S streams ------------------------------
    def _track(self, res: NMSResult, feats: torch.Tensor | None, luma, scale_xy
               ) -> TrackOutputs:
        """GMC and the tracker over the T frames of (T, S, ...) detections in
        order: ByteTrack batched over S, the others stream by stream.
        ``luma``: (T, S, ...) luma sources for GMC (grids or BGR frames)."""
        pipe = self._pipe
        if self._batched:
            pipe.tracker.state, pipe._gmc_carry = self.state, self._gmc_carry
            outs = pipe.track_chunk(res, feats, luma, scale_xy)
            self.state, self._gmc_carry = pipe.tracker.state, pipe._gmc_carry
            return outs
        per = []
        for si in range(self.local_streams):
            pipe.tracker.state, pipe._gmc_carry = self.state[si], self._gmc_carry[si]
            per.append(pipe.track_chunk(NMSResult(*(x[:, si] for x in res)),
                                        None if feats is None else feats[:, si],
                                        None if luma is None else luma[:, si], scale_xy))
            self.state[si], self._gmc_carry[si] = pipe.tracker.state, pipe._gmc_carry
        return TrackOutputs(*(torch.stack(f, dim=1) for f in zip(*per)))

    def _local(self, x, s: int):
        """This rank's streams of a (T, S, ...) input that carries every
        stream or this rank's."""
        if s == self.local_streams:
            return x
        if s != self.num_streams:
            raise ValueError(f"{s} streams in the input for a {self.num_streams}-stream pipeline"
                             + (f" ({self.local_streams} on this rank)"
                                if self.mesh.world > 1 else ""))
        return x[:, self.stream_slice]

    # -- BGR frames ------------------------------------------------------------
    @torch.no_grad()
    def step_chunk(self, frames: np.ndarray | torch.Tensor) -> tuple[TrackOutputs, NMSResult]:
        """frames (T, S, H, W, 3) uint8 BGR -> (outputs, detections) with
        leading (T, S) axes, detections in source coordinates: the BGR
        letterbox and the forward over the T * S frames at once, NMS once
        over them, then per frame GMC on the full-resolution frames and the
        tracker."""
        frames = self._local(frames, frames.shape[1])
        t, s, h, w = frames.shape[:4]
        fdev = torch.as_tensor(frames).to(self.device).reshape(t * s, h, w, 3)
        res, feats = self._pipe.bgr_detect(fdev)
        res = NMSResult(*(_split_ts(x, t, s) for x in res))
        g = self.cfg.tracking.gmc.grid
        luma = _split_ts(fdev, t, s) if self._gmc_on else None
        outs = self._track(res, None if feats is None else _split_ts(feats, t, s), luma,
                           (w / g, h / g))
        return outs, res

    def step(self, frames: np.ndarray | torch.Tensor) -> tuple[TrackOutputs, NMSResult]:
        """frames (S, H, W, 3) uint8 BGR -> (outputs, detections) with a
        leading axis of this rank's streams."""
        outs, res = self.step_chunk(frames[None])
        return TrackOutputs(*(x[0] for x in outs)), NMSResult(*(x[0] for x in res))

    # -- planar I420 chunks ----------------------------------------------------
    @torch.no_grad()
    def submit_chunk_packed(self, planes, src_h: int, src_w: int
                            ) -> tuple[TrackOutputs, NMSResult]:
        """Run one packed chunk: ``planes`` = (y (T, S, ch, cw), u (T, S,
        ch/2, cw/2), v) uint8 as numpy arrays or tensors, or one pre-packed
        x6 (T, S, ch/2, cw/2, 6) or x24 (T, S, ch/4, cw/4, 24) array held to
        the transport's level as in ``Pipeline.submit_packed_yuv``.  The
        single-stream packed program's stages (``Pipeline.packed_detect``:
        planar letterbox, forward, K1, crops + embedder, half-res GMC grids)
        over the T * S frames, then the tracker T times.  Returns the device
        (TrackOutputs, NMSResult), (T, S) leading."""
        if isinstance(planes, (np.ndarray, torch.Tensor)):
            planes = self._local(planes, planes.shape[1])
            t, s = planes.shape[:2]
            flat = planes.reshape(t * s, *planes.shape[2:])
        else:
            planes = tuple(self._local(p, planes[0].shape[1]) for p in planes)
            t, s = planes[0].shape[:2]
            flat = tuple(p.reshape(t * s, *p.shape[2:]) for p in planes)
        res, feats, grids, scale = self._pipe.packed_detect(flat, src_h, src_w)
        res = NMSResult(*(_split_ts(x, t, s) for x in res))
        outs = self._track(res, None if feats is None else _split_ts(feats, t, s),
                           None if grids is None else _split_ts(grids, t, s), scale)
        self.chunks_submitted += 1
        return outs, res

    # -- the multi-camera loop -------------------------------------------------
    def run(self, sources: list, max_frames: int | None = None,
            chunk_size: int | None = None, display: bool = False,
            state_path: str | None = None, state_interval: int = 300) -> dict:
        """Detect, track and raise zone events on S sources (video paths,
        RTSP URLs or webcam indices; one per stream, sharing one resolution)
        until every stream has ended, or ``max_frames`` frames per stream
        (0 or None: no limit).  Chunks of T = ``chunk_size`` (default
        ``max(2, parallel.chunk_size)``) frames per stream, ``pipeline_depth``
        chunks in flight.  A stream that ends (file EOF) or dies is fed
        blank frames from then on, with its frame ids and stream clock
        continued; it is listed in ``dead_streams``.  Returns a summary:
        ``frames``, ``streams``, ``fps_aggregate``, ``fps_per_stream``,
        ``per_stream_frames``, ``dead_streams`` and, with events on,
        ``zone_counts`` per stream.  Over several ranks every rank passes
        all S ``sources`` and reads its own; rank 0 returns the summary of
        every stream, the others None.

        ``state_path`` enables kill-and-resume snapshots: one after every
        ``state_interval`` frames of all streams (the window drained first)
        and at clean exit.  Where the snapshot exists at start it is
        restored before the ingest threads start: each FILE source drops the
        frames its stream consumed before (live sources continue from their
        current frame), ``per_stream_frames`` counts on from the snapshot's,
        and a stream that had ended stays dead and is fed blank frames, as it
        would be in an uninterrupted run."""
        if len(sources) != self.num_streams:
            raise ValueError(f"{len(sources)} sources for {self.num_streams} streams")
        mesh, off = self.mesh, self.stream_offset
        sources = list(sources[self.stream_slice])        # this rank's streams
        s_streams = self.local_streams
        t_chunk = chunk_size or max(2, self.cfg.parallel.chunk_size)
        depth = max(0, self.cfg.parallel.pipeline_depth)
        icfg, ecfg, vcfg = self.cfg.ingestion, self.cfg.events, self.cfg.visualization
        size = self.cfg.detection.input_size
        names = self.detector.class_names
        engines = None
        if ecfg.enabled and ecfg.zones:
            trail = self.cfg.tracking.trail_length
            engines = [ZoneEventEngine.from_config(ecfg, trail_length=trail)
                       for _ in range(s_streams)]
            for si, eng in enumerate(engines):
                eng.extra_metadata = {"stream": off + si}
        # kill-and-resume: restore the state before the ingest threads start,
        # so that each file source knows how many frames to drop
        resume = None
        if state_path and os.path.exists(state_path):
            from rtmodt_tpu_torch.runtime.state_store import load_multistream_snapshot

            resume = load_multistream_snapshot(state_path, self, engines)
        skip_frames = ([int(n) for n in resume["per_stream_frames"]] if resume
                       else [0] * s_streams)
        dead = [bool(d) for d in resume["dead"]] if resume else [False] * s_streams
        # the annotated mosaic (window, video file and/or MJPEG monitor) is
        # opt-in: the headless loop keeps no BGR frame on the host.  Every
        # rank draws its streams' tiles; rank 0 tiles them and alone writes,
        # publishes and shows
        render_on = display or vcfg.save_video or vcfg.mjpeg_port is not None
        lead = mesh.rank == 0
        display = display and lead
        annot = (MosaicAnnotator(vcfg, names, self.num_streams, range(off, off + s_streams))
                 if render_on else None)
        monitor = None
        if vcfg.mjpeg_port is not None and lead:
            from rtmodt_tpu_torch.serving.monitor import LiveMonitor

            monitor = LiveMonitor(vcfg.mjpeg_port)
        render_zones = engines[0].get_zone_polygons() if (render_on and engines) else []
        writer = None

        qs: list[queue.Queue] = [queue.Queue(maxsize=3 * t_chunk) for _ in range(s_streams)]
        stop = threading.Event()
        # a dead stream's blank frames keep its rate, which its reader gave
        # before the snapshot
        fps_by_stream = [float(f) for f in resume.get("fps", [30.0] * s_streams)] if resume \
            else [30.0] * s_streams

        def put(si: int, item) -> None:
            """Bounded put on stream si's queue that gives up once ``stop``
            is set."""
            while not stop.is_set():
                try:
                    qs[si].put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def ingest(si: int) -> None:
            """Decode and pack one stream; a None sentinel marks its end."""
            try:
                with RTSPReader(sources[si], backend=icfg.backend,
                                reconnect_delay_sec=icfg.reconnect_delay_sec,
                                max_reconnects=icfg.max_reconnects,
                                resolution=tuple(icfg.resolution) if icfg.resolution else None
                                ) as rd:
                    if rd.fps and rd.fps > 0:
                        fps_by_stream[si] = float(rd.fps)
                    last_id = 0
                    # resume fast-forward: decode and drop the frames an earlier
                    # run consumed, so the stream clock continues exactly; file
                    # sources only (a live source resumes at its current frame)
                    dropped = 0
                    while dropped < skip_frames[si] and rd._is_file and not stop.is_set():
                        frame, fid, _ = rd.read_new(last_id, timeout=2.0)
                        if frame is None:
                            if rd.is_eof:
                                break
                            continue
                        last_id = fid
                        dropped += 1
                    while not stop.is_set():
                        frame, fid, ts = rd.read_new(last_id, timeout=2.0)
                        if frame is None:
                            if rd.is_eof:
                                break
                            continue
                        last_id = fid
                        planes, _ = pack_i420_planar(frame, size)
                        put(si, (planes, frame.shape[:2], fid, ts, frame if render_on else None))
            except Exception as e:   # reported through the sentinel and the log
                logger.error(f"stream {si} ingest failed: {e}")
            # the sentinel waits for room like a frame: dropped on a full
            # queue (as the reference drops it), the consumer would notice the
            # end only after a 2 s get timeout per stream
            put(si, None)

        # a stream that was dead at the snapshot gets no reader
        workers = {si: threading.Thread(target=ingest, args=(si,), daemon=True,
                                        name=f"rtmodt-ingest-{si}")
                   for si in range(s_streams) if not dead[si]}
        for wk in workers.values():
            wk.start()

        inflight: deque = deque()
        frames_done = n_chunks = 0
        frames_all = 0       # every rank's real frames: the mosaic's aggregate fps
        quit_asked = False   # the display window's 'q' (rank 0); every rank stops on it
        src_hw = None
        t_start = None

        def consume(entry) -> None:
            """Host half of one chunk: events and the mosaic."""
            nonlocal frames_done, frames_all, writer, quit_asked
            metas, outs, n_real, n_all, bgrs, live = entry
            host = TrackOutputs(*(x.cpu().numpy() for x in outs))
            if engines is not None:
                for si in range(s_streams):
                    engines[si].process_chunk(
                        host.track_id[:, si], host.class_id[:, si], host.boxes[:, si],
                        host.visible[:, si], [m[si][0] for m in metas],
                        np.asarray([m[si][1] for m in metas], np.float64), class_names=names)
            frames_done += n_real
            frames_all += n_all
            if annot is None:
                return
            import cv2

            # rows with no real frame on any rank (the last chunk's tail) are
            # not drawn
            shape = (*src_hw, 3)
            tiles = [annot.tiles(host, t, row, render_zones, shape)
                     for t, row in enumerate(bgrs) if live[t]]
            parts = gather_objects(tiles, mesh)   # rank order is stream order
            if parts is None or quit_asked:
                return
            elapsed = (time.perf_counter() - t_start) if t_start else 0.0
            fps_now = frames_all / elapsed if elapsed > 0 else 0.0
            for t in range(len(tiles)):
                grid = annot.grid([tile for part in parts for tile in part[t]], fps_now)
                if monitor is not None:
                    monitor.publish(grid)
                if vcfg.save_video:
                    if writer is None:
                        os.makedirs(os.path.dirname(vcfg.save_path) or ".", exist_ok=True)
                        writer = cv2.VideoWriter(
                            vcfg.save_path, cv2.VideoWriter_fourcc(*vcfg.codec),
                            fps_by_stream[0] if fps_by_stream[0] > 0 else 25.0,
                            (grid.shape[1], grid.shape[0]))
                    writer.write(grid)
                if display:
                    cv2.imshow(vcfg.window_name, grid)
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        quit_asked = True
                        return

        # per-stream (fid, ts), continued by blanks; per_stream_frames counts
        # across restarts, so the next snapshot's fast-forward covers them all
        last_meta = ([(int(f), float(t)) for f, t in resume["last_meta"]] if resume
                     else [(0, 0.0)] * s_streams)
        per_stream_frames = list(skip_frames)
        # every stream's frames (all ranks'): the snapshot interval counts them
        all_frames = resume["total_frames"] if resume else 0
        last_snap = all_frames
        aborted = False

        def drain() -> None:
            while inflight:
                consume(inflight.popleft())

        def snapshot() -> None:
            from rtmodt_tpu_torch.runtime.state_store import save_multistream_snapshot

            save_multistream_snapshot(state_path, self, engines,
                                      per_stream_frames=per_stream_frames,
                                      last_meta=last_meta, dead=dead, fps=fps_by_stream)

        try:
            while True:
                if max_frames and n_chunks * t_chunk >= max_frames:
                    break
                # one time-aligned (T, S) block; a stream whose sentinel
                # arrives goes dead and contributes blanks from then on
                block: list[list] = [[] for _ in range(s_streams)]
                for si in range(s_streams):
                    while not dead[si] and len(block[si]) < t_chunk:
                        try:
                            item = qs[si].get(timeout=2.0)
                        except queue.Empty:
                            if workers[si].is_alive():
                                continue
                            item = None   # the worker died and its sentinel was dropped
                        if item is None:
                            dead[si] = True
                            logger.info(f"stream {si} ended; continuing degraded (blank frames)")
                            break
                        block[si].append(item)
                n_real = sum(len(b) for b in block)
                # every rank runs until every stream is done, feeding its ended
                # streams blanks meanwhile, as one process does; a rank whose
                # streams gave no frame yet takes the others' resolution
                own = src_hw or (next(b for b in block if b)[0][1] if n_real else None)
                rows = ([any(len(b) > t for b in block) for t in range(t_chunk)]
                        if render_on else [])
                n_all, known, h_sum, w_sum, quit_all, *live = sum_ints(
                    [n_real, own is not None, *(own or (0, 0)), quit_asked, *rows], mesh)
                if quit_all:     # the display window asked to quit
                    inflight.clear()
                    aborted = True
                    break
                if n_all == 0:   # every stream is done
                    break
                all_frames += n_all
                hw = (h_sum // known, w_sum // known)
                if own is not None and (tuple(own) != hw or hw[0] * known != h_sum
                                        or hw[1] * known != w_sum):
                    raise ValueError(f"streams of another rank have another resolution than "
                                     f"{tuple(own)}; all streams must share one resolution")
                if src_hw is None:
                    src_hw = hw
                    ch, cw = content_dims(*src_hw, size)
                # fresh buffers per block: an in-flight chunk may still be
                # reading the previous ones
                y = np.empty((t_chunk, s_streams, ch, cw), np.uint8)
                u = np.empty((t_chunk, s_streams, ch // 2, cw // 2), np.uint8)
                v = np.empty((t_chunk, s_streams, ch // 2, cw // 2), np.uint8)
                metas, bgrs = [], []
                for t in range(t_chunk):
                    row, brow = [], []
                    for si in range(s_streams):
                        bgr = None
                        if t < len(block[si]):
                            planes, hw, fid, ts, bgr = block[si][t]
                            if hw != src_hw:
                                raise ValueError(f"stream {si} resolution {hw} != {src_hw}; "
                                                 "all streams must share one resolution")
                            y[t, si], u[t, si], v[t, si] = planes
                            last_meta[si] = (fid, ts)
                            per_stream_frames[si] += 1
                        else:   # a dead or short slot: a blank frame on the stream's clock
                            y[t, si], u[t, si], v[t, si] = 0, 128, 128
                            last_meta[si] = (last_meta[si][0] + 1,
                                             last_meta[si][1] + 1.0 / fps_by_stream[si])
                        row.append(last_meta[si])
                        brow.append(bgr)
                    metas.append(row)
                    bgrs.append(brow)
                outs, _ = self.submit_chunk_packed((y, u, v), *src_hw)
                inflight.append((metas, outs, n_real, n_all, bgrs, [n > 0 for n in live]))
                n_chunks += 1
                if t_start is None:
                    t_start = time.perf_counter()
                if len(inflight) > depth:
                    consume(inflight.popleft())
                if state_path and all_frames - last_snap >= state_interval:
                    # drain first: the tracker state (updated at submit) and the
                    # engines (updated at consume) must describe the same frames
                    drain()
                    snapshot()
                    last_snap = all_frames
            drain()
            # a quit asked while the last chunks drained skips the clean-exit
            # snapshot on every rank
            quit_all = sum_ints([quit_asked], mesh)[0]
            aborted = aborted or quit_all > 0
            if state_path and not aborted and t_start is not None:
                snapshot()   # the clean-exit snapshot covers the whole run
        finally:
            stop.set()
            for q in qs:   # unblock a producer stuck on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
            for wk in workers.values():
                wk.join(timeout=5.0)
            if monitor is not None:
                monitor.close()
            if writer is not None:
                writer.release()
                logger.info(f"mosaic video written: {vcfg.save_path}")
            if display:
                import cv2

                cv2.destroyAllWindows()
        wall = (time.perf_counter() - t_start) if t_start else 0.0
        part = {"frames": frames_done, "wall": wall, "per_stream_frames": per_stream_frames,
                "dead_streams": [off + si for si, d in enumerate(dead) if d],
                "zone_counts": (None if engines is None
                                else [eng.zone_counts() for eng in engines])}
        parts = gather_objects(part, mesh)   # rank order is stream order
        if parts is None:
            return None
        frames = sum(p["frames"] for p in parts)
        wall = max(p["wall"] for p in parts)
        fps = frames / wall if wall > 0 else 0.0
        summary = {
            "frames": frames,
            "streams": self.num_streams,
            "fps_aggregate": round(fps, 1),
            "fps_per_stream": round(fps / self.num_streams, 1),
            "per_stream_frames": [n for p in parts for n in p["per_stream_frames"]],
            "dead_streams": [si for p in parts for si in p["dead_streams"]],
        }
        if engines is not None:
            summary["zone_counts"] = [c for p in parts for c in p["zone_counts"]]
        logger.info(f"multi-stream run: {frames} frames over {self.num_streams} streams"
                    + (f" on {mesh.world} ranks" if mesh.world > 1 else "")
                    + f", {summary['fps_aggregate']} fps aggregate "
                    f"({summary['fps_per_stream']}/stream)")
        return summary
