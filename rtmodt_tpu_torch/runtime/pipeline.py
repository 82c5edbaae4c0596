"""The live pipeline: decode -> detect -> track -> events -> render.

Port of ``rtmodt_tpu/runtime/pipeline.py`` (one stream).  Execution modes:

  * per-stage (``profiling.per_stage: true``, the reference default):
    ``step`` runs the BGR letterbox, the YOLOv8 forward, NMS (the CUDA
    kernel K1 at B = 1) and the tracker update as separate stages, each
    timed by the profiler with a sync of the card; tensors stay on the
    device between stages, only the visible tracks come back to the host.
    The tracking stage also runs GMC on the full-resolution BGR frame and,
    for deepsort / botsort, the ROI crops of that frame and the embedder;
  * packed per-frame (``per_stage: false``): the host packs each frame to
    planar I420 at content size (``ops/yuv.py::pack_chunk``) and the device
    runs ``planar_letterbox`` -> forward -> NMS -> tracker for it
    (``step_packed``, or ``submit_packed_frame`` with a ``pipeline_depth``
    window in ``run``).  Appearance crops come from the padded Y/U/V planes
    (``ops/roi.py::crop_yuv_rgb``) and GMC reads ``half_res_luma`` of the
    content Y plane.  The trackers' greedy assignment syncs the host on
    every round (``ops/assignment.py``), so the window holds back only the
    host's half of each frame (events, render) and overlaps no device work;
    a sync-free tracker (ROADMAP §1b) would make it real.  With
    ``parallel.transport: bgr`` the loop runs the reference's fused BGR
    program instead (``step``, or ``submit`` in the window): GMC on the
    source frame, the BGR letterbox, forward, NMS and the tracker, with
    appearance crops from the letterboxed image;
  * chunked (``run_chunked``): K frames per chunk, packed to pinned host
    buffers; the forward, NMS, crops and embedder run batched over the
    chunk, GMC and the tracker once per frame in order, and the host runs
    ``ZoneEventEngine.process_chunk`` for every frame.  ``run`` takes this
    path when ``parallel.chunk_size > 1`` and nothing per-frame is asked for
    (no per-stage timing, display, renderer or saved video).

``tracking.bytetrack.assignment: lapjv`` tracks on the host: ``step`` runs
the detection stages on the device and the host tracker after them, on
either ``per_stage`` setting, and ``run`` always takes that path (as the
reference does); ``step_packed`` and ``run_chunked`` refuse it.

The GMC carry (the previous frame's luma grid and a validity flag) lives
across frames and chunks; ``reset`` clears it.  ``warmup`` puts back the
tracker state, the trails and the carry it found, so dummy frames neither
leave phantom tracks nor shift the first real frame, and a state restored
from a snapshot survives it.

Kill-and-resume: ``run`` and ``run_chunked`` take ``state_path`` (write a
snapshot every ``state_interval`` consumed frames, at a drained window, and
at clean exit; ``runtime/state_store.py``) and ``skip_frames`` (the frames of
a FILE source a resumed run drops first, as ``load_runtime_state`` returns
them).  Transports of the chunked path (``parallel.transport``): planar I420
(``packed``, ``i420``, and ``x6`` / ``x24``, whose link bytes equal the
planes', so the planes ship for them too), or ``bgr`` frames through
``submit_chunk``.  With ``events.device_masks`` the zone containment of each
chunk's slot boxes runs on the device (``ops/polygon.py``).

Frames come from the port's ``RTSPReader``: ids count from 1, file frames
carry their stream time, live sources keep only the newest frame.

Device traces (``profiling.trace_dir``): ``_maybe_trace`` runs where the
reference's does, at the top of ``step``, ``step_packed`` and
``submit_packed_frame`` and once per full chunk dispatch of ``run_chunked``
(not in ``submit``).  Its first call starts a torch.profiler capture
(``profiling/trace_summary.py::start_trace``), the next ``trace_frames``
calls count down, and the one that reaches 0 stops it and writes one
``*.pt.trace.json.gz`` into ``trace_dir``; one capture per pipeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from rtmodt_tpu_torch.config.loader import PipelineConfig, load_config
from rtmodt_tpu_torch.detection.detector import Detections, Detector, build_detector  # noqa: F401
from rtmodt_tpu_torch.device import config_device, resolve_device
from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine
from rtmodt_tpu_torch.ingestion.rtsp_reader import RTSPReader
from rtmodt_tpu_torch.ops.gmc import gmc_step, half_res_luma, init_carry, luma_grids
from rtmodt_tpu_torch.ops.letterbox import (LetterboxMeta, letterbox, letterbox_meta,
                                            unletterbox_boxes)
from rtmodt_tpu_torch.ops.nms import NMSResult, batched_nms_from_logits
from rtmodt_tpu_torch.ops.polygon import pad_polygons, points_in_polygons
from rtmodt_tpu_torch.ops.roi import crop_and_resize, crop_yuv_rgb
from rtmodt_tpu_torch.ops.yuv import (check_prepacked, content_dims, pack_chunk, packed_meta,
                                      pad_planes, planar_letterbox, s2d_level,
                                      s2d_to_planes,
                                      unletterbox_boxes_packed)
from rtmodt_tpu_torch.profiling.latency_profiler import LatencyProfiler
from rtmodt_tpu_torch.profiling.spans import span
from rtmodt_tpu_torch.profiling.trace_summary import start_trace, stop_trace
from rtmodt_tpu_torch.tracking.bytetrack import TrackOutputs
from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker
from rtmodt_tpu_torch.utils.logging import logger
from rtmodt_tpu_torch.visualization.renderer import FrameRenderer


def _reader_frames(reader: RTSPReader) -> Iterator[tuple[np.ndarray, int, float]]:
    """(frame, frame_id, stream timestamp) of a started reader, each frame
    once, until the end of the stream."""
    last_id = 0
    while True:
        frame, fid, ts = reader.read_new(last_id, timeout=2.0)
        if frame is None:
            if reader.is_eof:
                return
            continue
        last_id = fid
        yield frame, fid, ts


class _Slot:
    """Host buffers of one in-flight chunk, pinned on the card's host: the
    packed input planes, the fetched track outputs and, with ``zones`` > 0,
    the device zone masks."""

    def __init__(self, k: int, ch: int, cw: int, s: int, pin: bool, zones: int = 0):
        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        self.planes_t = (buf((k, ch, cw), torch.uint8),
                         buf((k, ch // 2, cw // 2), torch.uint8),
                         buf((k, ch // 2, cw // 2), torch.uint8))
        self.planes = tuple(t.numpy() for t in self.planes_t)
        self.out = TrackOutputs(
            boxes=buf((k, s, 4), torch.float32), track_id=buf((k, s), torch.int32),
            class_id=buf((k, s), torch.int32), confidence=buf((k, s), torch.float32),
            age=buf((k, s), torch.int32), tsu=buf((k, s), torch.int32),
            visible=buf((k, s), torch.bool))
        self.inside = buf((k, s, zones), torch.bool) if zones else None


class Pipeline:
    """One stream end to end.  ``device`` wins over ``system.device``; the
    config's default names the card, and asked for the card where CUDA is
    absent the pipeline raises (``device="cpu"`` runs on the CPU)."""

    def __init__(self, cfg: PipelineConfig | None = None, device: str | None = None,
                 seed: int = 0, warmup_shape: tuple[int, int] | None = None):
        self.cfg = cfg if cfg is not None else load_config()
        self.device = resolve_device(device if device is not None
                                     else config_device(self.cfg.system.device))
        self.detector = Detector(self.cfg.detection, self.device, warmup=False, seed=seed)
        t = self.cfg.tracking
        self.tracker = MultiObjectTracker(
            t.algorithm, trail_length=t.trail_length, device=self.device,
            bytetrack=t.bytetrack, deepsort=t.deepsort, botsort=t.botsort, ocsort=t.ocsort,
            gmc=t.gmc)
        self._is_appearance = self.tracker.algorithm in ("deepsort", "botsort")
        self._host_tracker = self.tracker._host is not None
        self._gmc_on = t.gmc.method == "phase"
        self._gmc_carry = None
        v = self.cfg.visualization
        # the live monitor streams annotated frames, so mjpeg_port implies
        # the renderer
        self.renderer = FrameRenderer(
            show_boxes=v.show_boxes, show_labels=v.show_labels,
            show_trails=v.show_trails, show_zones=v.show_zones,
            show_hud=v.show_hud, trail_length=v.trail_length,
        ) if (v.enabled or v.mjpeg_port is not None) else None
        self._per_stage = self.cfg.profiling.per_stage
        self._trace_state = {"frames_left": 0, "active": False}
        self.reset()
        if warmup_shape:
            self.warmup(warmup_shape)

    def reset(self) -> None:
        """Start a new stream: empty track slots, no GMC history, fresh
        zone-event state, a fresh profiler."""
        self.tracker.reset()
        self._gmc_reset()
        ev = self.cfg.events
        self.events = (ZoneEventEngine.from_config(ev, trail_length=self.cfg.tracking.trail_length)
                       if ev.enabled and ev.zones else None)
        # events.device_masks: the zones padded to (Z, max_vertices, 2) on the
        # device, for mask_chunk
        self._mask_polys = None
        if self.events is not None and ev.device_masks:
            self._mask_polys = torch.from_numpy(pad_polygons(
                [z.polygon.tolist() for z in self.events.zones], ev.max_vertices)
            ).to(self.device)
        pc = self.cfg.profiling
        self.profiler = LatencyProfiler(enabled=pc.enabled, warmup_frames=pc.warmup_frames,
                                        log_interval=pc.log_interval)
        self.chunks_submitted = 0

    # -- camera motion compensation -----------------------------------------
    def _gmc_reset(self) -> None:
        """A zero grid with valid = 0: the next frame compensates nothing."""
        self._gmc_carry = (init_carry(self.cfg.tracking.gmc.grid, self.device)
                           if self._gmc_on else None)

    def _gmc(self, luma_src: torch.Tensor, scale_xy: tuple[float, float]) -> None:
        """Shift the tracker state by the camera motion between the carried
        grid and this frame's (a luma plane, a BGR frame or a grid)."""
        self.tracker.state, self._gmc_carry = gmc_step(
            self.tracker.state, luma_src, self._gmc_carry, self.cfg.tracking.gmc, scale_xy)

    def _refuse_host_tracker(self, what: str) -> None:
        if self._host_tracker:
            raise ValueError(f"tracking.bytetrack.assignment=lapjv tracks on the host per "
                             f"frame through Pipeline.step (run takes that path); {what} "
                             "runs a device tracker")

    # -- the chunk program -------------------------------------------------
    @torch.no_grad()
    def detect_chunk(self, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     meta: LetterboxMeta, to_source: bool = True) -> NMSResult:
        """Device planes (K, ch, cw) / (K, ch/2, cw/2) uint8 -> detections of
        the K frames in source coordinates (model-input coordinates with
        ``to_source=False``)."""
        d = self.cfg.detection
        img = planar_letterbox(y, u, v, d.input_size, meta.pad_left, meta.pad_top,
                               dtype=self.detector.dtype)
        # NHWC storage is a channels_last NCHW tensor: no copy
        box_dist, cls_logits = self.detector.model(img.permute(0, 3, 1, 2))
        res = batched_nms_from_logits(
            box_dist, cls_logits, d.input_size, d.conf_threshold, d.iou_threshold,
            d.max_detections, d.nms_candidates, self.detector._class_mask, d.agnostic_nms)
        if to_source:
            res = res._replace(boxes=unletterbox_boxes_packed(res.boxes, meta))
        return res

    @torch.no_grad()
    def embed_chunk(self, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    boxes: torch.Tensor, meta: LetterboxMeta) -> torch.Tensor:
        """Appearance embeddings (K, D, E) of the K frames' detections:
        ``boxes`` (K, D, 4) in model-input coordinates, crops from the padded
        Y/U/V planes (per-crop BT.601), one embedder call for the chunk."""
        size = self.cfg.detection.input_size
        yp, up, vp = pad_planes(y, u, v, size, meta.pad_left, meta.pad_top)
        crop_hw = tuple(self.tracker.cfg.crop_hw)
        crops = crop_yuv_rgb(yp.float(), up.float(), vp.float(), boxes, crop_hw)
        k, n = boxes.shape[:2]
        return self.tracker.embedder(crops.reshape(k * n, *crops.shape[2:])).reshape(k, n, -1)

    @torch.no_grad()
    def bgr_detect(self, frames: torch.Tensor) -> tuple[NMSResult, torch.Tensor | None]:
        """Device BGR frames (N, H, W, 3) uint8 -> (detections in source
        coordinates, appearance embeddings (N, D, E) or None): the batched
        BGR letterbox, the forward and NMS (K1 at B = N) over the N frames;
        the crops come from the letterboxed frames (the reference's fused
        BGR programs)."""
        d = self.cfg.detection
        det = self.detector
        n, h, w = frames.shape[:3]
        img, _ = letterbox(frames, d.input_size, dtype=det.dtype)
        box_dist, cls_logits = det.model(img.permute(0, 3, 1, 2))
        res = batched_nms_from_logits(
            box_dist, cls_logits, d.input_size, d.conf_threshold, d.iou_threshold,
            d.max_detections, d.nms_candidates, det._class_mask, d.agnostic_nms)
        feats = None
        if self._is_appearance:
            crops = crop_and_resize(img, res.boxes, tuple(self.tracker.cfg.crop_hw)) * 255.0
            m = res.boxes.shape[1]
            feats = self.tracker.embedder(crops.reshape(n * m, *crops.shape[2:])).reshape(n, m, -1)
        res = res._replace(boxes=unletterbox_boxes(res.boxes, letterbox_meta(h, w, d.input_size)))
        return res, feats

    @torch.no_grad()
    def mask_chunk(self, boxes: torch.Tensor) -> torch.Tensor:
        """``events.device_masks``: slot boxes (..., S, 4) -> (..., S, Z) bool,
        each slot box's centre in each zone (even-odd rule, on the boxes'
        device)."""
        cents = (boxes[..., 0:2] + boxes[..., 2:4]) * 0.5
        inside = points_in_polygons(cents.reshape(-1, 2), self._mask_polys)
        return inside.reshape(*cents.shape[:-1], self._mask_polys.shape[0])

    @torch.no_grad()
    def track_chunk(self, res: NMSResult, feats: torch.Tensor | None = None,
                    grids: torch.Tensor | None = None,
                    scale_xy: tuple[float, float] = (1.0, 1.0)) -> TrackOutputs:
        """GMC (with the frames' luma ``grids``, or any luma source
        ``gmc_step`` takes) and the tracker over the K frames in order;
        outputs stacked (K, S, ...).  The tracker state may carry a stream
        axis (``parallel/multistream.py``).  The ``track`` span."""
        with span("track"):
            outs = []
            for i in range(res.boxes.shape[0]):
                if grids is not None:
                    self._gmc(grids[i], scale_xy)
                outs.append(self.tracker.step(res.boxes[i], res.scores[i], res.classes[i],
                                              res.valid[i], None if feats is None else feats[i]))
            return TrackOutputs(*(torch.stack(f) for f in zip(*outs)))

    def packed_detect(self, planes, src_h: int, src_w: int):
        """The per-frame half of the packed program, batched over the K
        frames of ``planes`` (numpy arrays or tensors): detections in source
        coordinates, the appearance embeddings (deepsort / botsort) and the
        GMC luma grids with their grid-to-source scale.  ``planes`` is (y, u,
        v), or one pre-packed x6 / x24 array that the device unpacks to them
        (``check_prepacked`` holds it to the transport's level first).
        Returns (res, feats or None, grids or None, scale_xy).  The ``detect``
        span."""
        with span("detect"):
            size = self.cfg.detection.input_size
            meta = packed_meta(src_h, src_w, size)
            ch, cw = content_dims(src_h, src_w, size)
            if isinstance(planes, (np.ndarray, torch.Tensor)):
                check_prepacked(planes, self.cfg.parallel.transport, src_h, src_w, size,
                                self._is_appearance)
                planes = s2d_to_planes(torch.as_tensor(planes).to(self.device, non_blocking=True))
            y, u, v = (torch.as_tensor(p).to(self.device, non_blocking=True) for p in planes)
            if tuple(y.shape[1:]) != (ch, cw):
                raise ValueError(f"Y planes are {tuple(y.shape[1:])}, expected {(ch, cw)} "
                                 f"for {src_w}x{src_h} input")
            res = self.detect_chunk(y, u, v, meta, to_source=False)
            feats = (self.embed_chunk(y, u, v, res.boxes, meta) if self._is_appearance
                     else None)
            res = res._replace(boxes=unletterbox_boxes_packed(res.boxes, meta))
            grids, scale = None, (1.0, 1.0)
            if self._gmc_on:
                # the content Y pooled to half resolution first, as the
                # reference's packed programs do
                g = self.cfg.tracking.gmc.grid
                grids = luma_grids(half_res_luma(y), g)
                scale = (src_w / g, src_h / g)
            return res, feats, grids, scale

    def _packed_program(self, planes, src_h: int, src_w: int
                        ) -> tuple[TrackOutputs, NMSResult]:
        self._refuse_host_tracker("the packed path")
        res, feats, grids, scale = self.packed_detect(planes, src_h, src_w)
        return self.track_chunk(res, feats, grids, scale), res

    def submit_packed_yuv(self, planes, src_h: int, src_w: int
                          ) -> tuple[TrackOutputs, NMSResult]:
        """Run one chunk: ``planes`` = (y (K, ch, cw), u, v) uint8 as numpy
        arrays or tensors (pinned host tensors copy without blocking), or the
        pre-packed space-to-depth array of an s2d transport, (K, ch/2, cw/2,
        6) x6 or (K, ch/4, cw/4, 24) x24 (``ops/yuv.py::planes_to_x6`` /
        ``planes_to_x24``), whose channel count must match the level
        ``s2d_level`` allows for this geometry.  Returns the device
        (TrackOutputs, NMSResult), K leading."""
        out = self._packed_program(planes, src_h, src_w)
        self.chunks_submitted += 1
        return out

    def submit_chunk_packed(self, frames_bgr: np.ndarray) -> tuple[TrackOutputs, NMSResult]:
        """Run one chunk of BGR frames (K, H, W, 3) uint8 on the packed
        program: the host packs it to planar I420 at content size
        (``pack_chunk``, each frame as ``pack_i420_planar`` packs it), then
        ``submit_packed_yuv``.  Returns the device (TrackOutputs, NMSResult),
        K leading."""
        self._refuse_host_tracker("submit_chunk_packed")
        h, w = frames_bgr.shape[1:3]
        planes, _ = pack_chunk(np.ascontiguousarray(frames_bgr), self.cfg.detection.input_size)
        return self.submit_packed_yuv(planes, h, w)

    @torch.no_grad()
    def submit_chunk(self, frames: np.ndarray | torch.Tensor) -> tuple[TrackOutputs, NMSResult]:
        """Run one chunk of BGR frames (K, H, W, 3) uint8 (``transport:
        bgr``): the batched BGR letterbox, the forward, K1 at B = K, then GMC
        on the full-resolution frames and the tracker K times.  Returns the
        device (TrackOutputs, NMSResult), K leading."""
        self._refuse_host_tracker("submit_chunk")
        k, h, w = frames.shape[:3]
        fdev = torch.as_tensor(frames).to(self.device)
        res, feats = self.bgr_detect(fdev)
        g = self.cfg.tracking.gmc.grid
        outs = self.track_chunk(res, feats, fdev if self._gmc_on else None, (w / g, h / g))
        self.chunks_submitted += 1
        return outs, res

    # -- kill-and-resume ---------------------------------------------------------
    def save_runtime_state(self, path: str, frames_done: int = 0, last_ts: float = 0.0) -> None:
        """Snapshot the tracker, the zone engine and the GMC carry
        (``runtime/state_store.py``).  Call only with no frame in flight:
        the tracker state must describe exactly ``frames_done`` frames."""
        from rtmodt_tpu_torch.runtime.state_store import save_snapshot

        save_snapshot(path, self.tracker, self.events, frames_done=frames_done,
                      last_ts=last_ts, gmc_carry=self._gmc_carry)

    def load_runtime_state(self, path: str) -> int:
        """Restore a snapshot; returns its ``frames_done``, the frames a
        resumed run over the same FILE passes as ``skip_frames``."""
        from rtmodt_tpu_torch.runtime.state_store import load_snapshot

        meta = load_snapshot(path, self.tracker, self.events, gmc_carry=self._gmc_carry)
        if self._gmc_on:
            if meta.get("gmc_carry") is not None:
                self._gmc_carry = meta["gmc_carry"]
            else:
                self._gmc_reset()
        return int(meta["frames_done"])

    # -- device traces -------------------------------------------------------
    def _maybe_trace(self) -> None:
        """With ``profiling.trace_dir`` set, capture the first
        ``trace_frames`` frames (chunk dispatches in ``run_chunked``) after
        the first traced call into a Chrome trace, viewable in Perfetto or
        TensorBoard and read by ``profiling/trace_summary.py``."""
        tcfg = self.cfg.profiling
        ts = self._trace_state
        if not tcfg.trace_dir:
            return
        if not ts["active"] and ts["frames_left"] == 0 and not ts.get("done"):
            ts["profiler"] = start_trace(tcfg.trace_dir, self.device)
            ts["active"] = True
            ts["frames_left"] = tcfg.trace_frames
            logger.info(f"torch.profiler trace started -> {tcfg.trace_dir}")
        elif ts["active"]:
            ts["frames_left"] -= 1
            if ts["frames_left"] <= 0:
                stop_trace(ts.pop("profiler"))
                ts["active"] = False
                ts["done"] = True
                logger.info("torch.profiler trace captured")

    # -- the per-frame paths -------------------------------------------------
    def warmup(self, shape_hw: tuple[int, int], iters: int = 3) -> None:
        """Run the stages of the configured per-frame path on a dummy frame
        (cuDNN picks its algorithms, the allocator fills its pools), then put
        back the tracker state and the GMC carry it found (it touches no
        trail): warmup leaves no phantom tracks and no dummy grid that would
        shift the first frame, and a state restored from a snapshot survives
        it (the reference resets to a fresh state here, which wipes a
        restored one on its per-frame paths)."""
        h, w = shape_hw
        dummy = np.zeros((h, w, 3), np.uint8)
        t0 = time.perf_counter()
        found = (self.tracker.state, self._gmc_carry)
        with torch.no_grad():
            for _ in range(iters):
                if self._per_stage or self._host_tracker:
                    fdev = torch.from_numpy(dummy).to(self.device)
                    res = self.detector.detect_device(fdev)
                    if not self._host_tracker:
                        feats = (self.tracker.embed_fn()(fdev, res.boxes)
                                 if self._is_appearance else None)
                        self.tracker.step(res.boxes, res.scores, res.classes, res.valid,
                                          feats)
                elif self._use_packed_transport():
                    planes, _ = pack_chunk(dummy[None], self.cfg.detection.input_size)
                    self._packed_program(planes, h, w)
                else:
                    self.submit(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.tracker.state, self._gmc_carry = found
        logger.info(f"pipeline warmup {w}x{h} done in {time.perf_counter() - t0:.1f}s")

    @torch.no_grad()
    def step(self, frame: np.ndarray, frame_id: int, timestamp: float | None = None):
        """Process one BGR frame.  Returns (tracks, events, nms_result).

        Per-stage mode times preprocess, inference, nms and tracking apart,
        each ended by a sync of the card; otherwise the detect + track step is
        timed as one ``inference`` stage."""
        self._maybe_trace()
        p = self.profiler
        det = self.detector
        h, w = frame.shape[:2]
        g = self.cfg.tracking.gmc.grid
        if self._per_stage or self._host_tracker:
            p.tick("preprocess")
            fdev = torch.from_numpy(frame).to(self.device)
            img = det.preprocess(fdev)
            p.tock("preprocess", sync_on=img)
            p.tick("inference")
            raw = det.forward(img)
            p.tock("inference", sync_on=raw)
            p.tick("nms")
            res = det.nms(raw, h, w)
            if self._host_tracker:
                res = NMSResult(*(t.cpu() for t in res))
            p.tock("nms", sync_on=res)
            p.tick("tracking")
            if self._host_tracker:
                n = int(res.count)
                tracks = self.tracker.update(Detections(
                    res.boxes[:n].numpy().astype(np.float32),
                    res.scores[:n].numpy().astype(np.float32),
                    res.classes[:n].numpy().astype(np.int32), det.class_names))
            else:
                if self._gmc_on:
                    # GMC on the full-resolution source frame, as the
                    # reference's per-stage path does
                    self._gmc(fdev, (w / g, h / g))
                feats = (self.tracker.embed_fn()(fdev, res.boxes) if self._is_appearance
                         else None)
                outputs = self.tracker.step(res.boxes, res.scores, res.classes, res.valid,
                                            feats)
                tracks = self.tracker.tracks_from_outputs(outputs, det.class_names)
            p.tock("tracking")
        else:
            p.tick("inference")
            outputs, res = self.submit(frame)
            tracks = self.tracker.tracks_from_outputs(outputs, det.class_names)
            p.tock("inference")
        p.tick("events")
        events = self.events.process(tracks, frame_id, timestamp) if self.events else []
        p.tock("events")
        return tracks, events, res

    @torch.no_grad()
    def submit(self, frame: np.ndarray) -> tuple[TrackOutputs, NMSResult]:
        """The reference's fused BGR per-frame program up to the tracker's
        outputs (``transport: bgr``, and ``step`` off the per-stage path): GMC
        on the source frame, the BGR letterbox, the forward, NMS (K1 at B =
        1), appearance crops from the letterboxed image, the tracker.  Not
        asynchronous: the tracker's assignment rounds sync the host.
        Returns the device (TrackOutputs, NMSResult) of the frame."""
        det = self.detector
        h, w = frame.shape[:2]
        g = self.cfg.tracking.gmc.grid
        fdev = torch.from_numpy(frame).to(self.device)
        if self._gmc_on:
            self._gmc(fdev, (w / g, h / g))
        img = det.preprocess(fdev)
        res = det.nms_letterboxed(det.forward(img))
        feats = (self.tracker.embed_fn(normalized=True)(img, res.boxes)
                 if self._is_appearance else None)
        res = det.to_source(res, h, w)
        return self.tracker.step(res.boxes, res.scores, res.classes, res.valid, feats), res

    def _use_packed_transport(self) -> bool:
        """The per-frame loop packs I420 unless ``transport: bgr`` asks for
        the BGR program; per-stage and host-tracker modes keep the BGR
        stages (the reference's rule)."""
        return (self.cfg.parallel.transport in ("packed", "x6", "x24", "i420")
                and not self._per_stage and not self._host_tracker)

    def submit_packed_frame(self, frame: np.ndarray) -> tuple[TrackOutputs, NMSResult]:
        """The packed per-frame step up to the tracker's outputs: the host
        packs the frame to planar I420, the device runs the detect + track
        program.  Not asynchronous: the tracker's assignment rounds sync the
        host.  Returns the device (TrackOutputs, NMSResult) of the frame."""
        self._maybe_trace()
        h, w = frame.shape[:2]
        planes, _ = pack_chunk(frame[None], self.cfg.detection.input_size)
        outs, res = self.submit_packed_yuv(planes, h, w)
        return (TrackOutputs(*(t[0] for t in outs)), NMSResult(*(t[0] for t in res)))

    def step_packed(self, frame: np.ndarray, frame_id: int, timestamp: float | None = None):
        """The packed per-frame path: one frame packed to planar I420 goes
        through ``planar_letterbox`` -> forward -> NMS -> ByteTrack.
        Returns (tracks, events, nms_result)."""
        self._maybe_trace()
        h, w = frame.shape[:2]
        planes, _ = pack_chunk(frame[None], self.cfg.detection.input_size)
        p = self.profiler
        p.tick("inference")
        outs, res = self.submit_packed_yuv(planes, h, w)
        outputs = TrackOutputs(*(t[0] for t in outs))
        tracks = self.tracker.tracks_from_outputs(outputs, self.detector.class_names)
        p.tock("inference")
        p.tick("events")
        events = self.events.process(tracks, frame_id, timestamp) if self.events else []
        p.tock("events")
        return tracks, events, NMSResult(*(t[0] for t in res))

    def _reader(self, source: str | int | None) -> RTSPReader:
        icfg = self.cfg.ingestion
        return RTSPReader(
            source if source is not None else icfg.source,
            backend=icfg.backend,
            reconnect_delay_sec=icfg.reconnect_delay_sec,
            max_reconnects=icfg.max_reconnects,
            resolution=tuple(icfg.resolution) if icfg.resolution else None,
            target_fps=icfg.target_fps,
        )

    # -- the CLI loop ----------------------------------------------------------
    def run(self, source: str | int | None = None, display: bool = False,
            max_frames: int | None = None, state_path: str | None = None,
            state_interval: int = 300, skip_frames: int = 0) -> dict[str, float]:
        """The full CLI loop over ``source`` (a video path, RTSP URL or webcam
        index; default ``ingestion.source``): detect, track, raise zone
        events, render, display and save the annotated video as configured;
        with ``visualization.mjpeg_port`` set, a ``LiveMonitor`` serves the
        annotated frames as MJPEG for the length of the run.  ``max_frames``
        of 0 or None means no limit.

        ``state_path`` enables kill-and-resume snapshots: written every
        ``state_interval`` consumed frames (the window drained first) and at
        clean exit.  A resumed run restores the snapshot first
        (``load_runtime_state``) and passes its ``frames_done`` as
        ``skip_frames``: a FILE source drops that many frames before the first
        one it processes; a live source continues from its current frame.
        Returns the profiler's summary."""
        vcfg = self.cfg.visualization
        if (self.cfg.parallel.chunk_size > 1 and not display and not vcfg.save_video
                and self.renderer is None and not self._per_stage
                and not self._host_tracker):
            return self.run_chunked(source, max_frames, state_path=state_path,
                                    state_interval=state_interval, skip_frames=skip_frames)
        import cv2

        reader = self._reader(source)
        writer = None
        monitor = None
        if vcfg.mjpeg_port is not None:
            from rtmodt_tpu_torch.serving.monitor import LiveMonitor

            monitor = LiveMonitor(vcfg.mjpeg_port)
        zones = self.events.get_zone_polygons() if self.events else []
        names = self.detector.class_names
        packed = self._use_packed_transport()
        depth = (0 if self._per_stage or self._host_tracker
                 else max(0, self.cfg.parallel.pipeline_depth))
        inflight: deque = deque()
        frames = skipped = consumed = snaps_done = 0
        last_ts = 0.0
        p = self.profiler
        warmed = False

        def finish(frame: np.ndarray, tracks: list, ts: float) -> bool:
            """Render, write and show one frame; False when the user quits."""
            nonlocal writer, consumed, last_ts
            consumed += 1
            last_ts = float(ts)
            if self.renderer is not None:
                p.tick("visualization")
                self.renderer.render(frame, tracks, zones, fps=p.current_fps,
                                     latency_ms=p.summary().get("total_mean_ms", 0.0))
                p.tock("visualization")
            p.end_frame()
            if monitor is not None:
                monitor.publish(frame)
            if vcfg.save_video:
                if writer is None:
                    os.makedirs(os.path.dirname(vcfg.save_path) or ".", exist_ok=True)
                    fps_out = reader.fps if reader.fps > 0 else 25.0
                    writer = cv2.VideoWriter(
                        vcfg.save_path, cv2.VideoWriter_fourcc(*vcfg.codec),
                        fps_out, (frame.shape[1], frame.shape[0]))
                writer.write(frame)
            if display:
                cv2.imshow(vcfg.window_name, frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    return False
            return True

        def consume(entry) -> bool:
            """Host half of one in-flight frame: tracks, events, render, write."""
            frame, fid, ts, outputs = entry
            p.tick("tracking")
            tracks = self.tracker.tracks_from_outputs(outputs, names)
            p.tock("tracking")
            p.tick("events")
            if self.events:
                self.events.process(tracks, fid, ts)
            p.tock("events")
            return finish(frame, tracks, ts)

        def drain() -> bool:
            while inflight:
                if not consume(inflight.popleft()):
                    return False
            return True

        try:
            with reader:
                stream = _reader_frames(reader)
                while True:
                    p.tick("decode")
                    item = next(stream, None)
                    p.tock("decode")
                    if item is None:
                        logger.info("end of stream")
                        break
                    frame, fid, ts = item
                    if skipped < skip_frames and reader._is_file:
                        # resume fast-forward: the run that wrote the snapshot
                        # consumed these; dropping them keeps the file's stream
                        # clock in line with the restored dwell timers
                        skipped += 1
                        continue
                    if not warmed:
                        self.warmup(frame.shape[:2])
                        warmed = True
                    if depth > 0:
                        # submit (the tracker syncs the host, so no device work
                        # overlaps); events and render of the oldest frame wait
                        # until the window is full
                        p.tick("inference")
                        outputs, _ = (self.submit_packed_frame(frame) if packed
                                      else self.submit(frame))
                        p.tock("inference")
                        inflight.append((frame, fid, ts, outputs))
                        if len(inflight) > depth and not consume(inflight.popleft()):
                            break
                    else:
                        tracks, _, _ = (self.step_packed(frame, fid, ts) if packed
                                        else self.step(frame, fid, ts))
                        if not finish(frame, tracks, ts):
                            break
                    frames += 1
                    if state_path and consumed // state_interval > snaps_done:
                        # drain first: the snapshot's tracker state must
                        # describe exactly the consumed frames
                        ok = drain()
                        self.save_runtime_state(state_path, skipped + consumed, last_ts)
                        snaps_done = consumed // state_interval
                        if not ok:
                            break
                    if max_frames and frames >= max_frames:
                        break
                drain()
                if state_path:
                    self.save_runtime_state(state_path, skipped + consumed, last_ts)
        except KeyboardInterrupt:
            logger.info("interrupted")
        finally:
            if monitor is not None:
                monitor.close()
            if writer is not None:
                writer.release()
            if display:
                cv2.destroyAllWindows()
        p.print_summary()
        return p.summary()

    # -- the throughput loop ----------------------------------------------
    def run_chunked(self, source: Iterable[np.ndarray] | str | int | None = None,
                    max_frames: int | None = None, fps: float = 30.0,
                    state_path: str | None = None, state_interval: int = 300,
                    skip_frames: int = 0) -> dict[str, float]:
        """Detect, track and raise zone events for every frame of ``source``
        in chunks of ``parallel.chunk_size`` (at least 2) with
        ``parallel.pipeline_depth`` chunks in flight.

        ``source`` is a video path, RTSP URL or webcam index (default
        ``ingestion.source``), read through ``RTSPReader`` with its frame ids
        and stream timestamps; or an iterable of BGR frames, whose frame ids
        count from 1 and whose stream time is (id - 1) / ``fps``.
        ``max_frames`` of 0 or None means no limit.

        ``state_path``, ``state_interval`` and ``skip_frames`` as in ``run``:
        a snapshot every ``state_interval`` consumed frames (the window
        drained first) and at clean exit.  An iterable of frames is a
        recording, like a file: its first ``skip_frames`` frames are dropped
        and ids and stream time still count from its first frame.  A padded
        final chunk is part of the clean-exit snapshot, as in the reference:
        the tracker has seen the copies of the last frame.

        Returns the profiler's summary with ``frames``, ``chunks``,
        ``seconds`` and ``fps``."""
        self._refuse_host_tracker("run_chunked")
        k = max(2, self.cfg.parallel.chunk_size)
        depth = max(0, self.cfg.parallel.pipeline_depth)
        size = self.cfg.detection.input_size
        s = self.tracker.cfg.max_tracks
        pin = self.device.type == "cuda"
        transport = self.cfg.parallel.transport
        # bgr ships frames; the appearance trackers' crops need the planes
        use_bgr = transport == "bgr" and not self._is_appearance
        zones = 0 if self._mask_polys is None else self._mask_polys.shape[0]
        p = self.profiler
        slots: list[_Slot] = []
        inflight: deque = deque()
        done = chunks = 0
        last_ts = 0.0
        t0 = time.perf_counter()

        def consume(entry) -> None:
            nonlocal done, last_ts
            metas, slot, ready = entry
            if ready is not None:
                ready.synchronize()
            n = len(metas)   # < K only for the padded final chunk
            if self.events is not None:
                o = slot.out
                self.events.process_chunk(
                    o.track_id.numpy()[:n], o.class_id.numpy()[:n],
                    o.boxes.numpy()[:n], o.visible.numpy()[:n],
                    [m[0] for m in metas], np.asarray([m[1] for m in metas], np.float64),
                    inside=None if slot.inside is None else slot.inside.numpy()[:n],
                    class_names=self.detector.class_names)
            for _ in metas:
                p.end_frame()
            done += n
            last_ts = float(metas[-1][1])

        def submit(frames: list[np.ndarray], metas: list) -> None:
            nonlocal chunks
            h, w = frames[0].shape[:2]
            if not slots:
                ch, cw = content_dims(h, w, size)
                if transport in ("x6", "x24"):
                    # x24 pinned on a geometry it cannot block raises; the
                    # planes ship, as their bytes equal the s2d layout's
                    s2d_level(transport, h, w, size)
                slots.extend(_Slot(k, ch, cw, s, pin, zones) for _ in range(depth + 1))
            # the slot's previous chunk was consumed (at most `depth` stay in
            # flight), so its host buffers are free to overwrite
            slot = slots[chunks % len(slots)]
            chunks += 1
            p.tick("inference")
            batch = np.stack(frames + [frames[-1]] * (k - len(frames)))
            if use_bgr:
                outs, _ = self.submit_chunk(batch)
            else:
                pack_chunk(batch, size, out=slot.planes)
                outs, _ = self.submit_packed_yuv(slot.planes_t, h, w)
            for dst, src in zip(slot.out, outs):
                dst.copy_(src, non_blocking=pin)
            if slot.inside is not None:
                slot.inside.copy_(self.mask_chunk(outs.boxes), non_blocking=pin)
            ready = None
            if pin:
                ready = torch.cuda.Event()
                ready.record()
            p.tock("inference")
            inflight.append((metas, slot, ready))
            if len(inflight) > depth:
                consume(inflight.popleft())

        live = source is None or isinstance(source, (str, int))
        reader = self._reader(source) if live else None
        skipped = snaps_done = 0
        with reader if reader is not None else contextlib.nullcontext():
            stream = (_reader_frames(reader) if reader is not None else
                      ((frame, i + 1, i / fps) for i, frame in enumerate(source)))
            droppable = reader is None or reader._is_file
            buf: list[np.ndarray] = []
            metas: list = []
            read = 0
            for frame, fid, ts in stream:
                if skipped < skip_frames and droppable:
                    # resume fast-forward (see run)
                    skipped += 1
                    continue
                buf.append(frame)
                metas.append((fid, ts))
                read += 1
                if len(buf) == k:
                    self._maybe_trace()   # trace_frames counts chunk dispatches here
                    submit(buf, metas)
                    buf, metas = [], []
                    if state_path and done // state_interval > snaps_done:
                        # drain first: the snapshot must describe a tracker
                        # that has seen exactly `done` frames
                        while inflight:
                            consume(inflight.popleft())
                        self.save_runtime_state(state_path, skipped + done, last_ts)
                        snaps_done = done // state_interval
                if max_frames and read >= max_frames:
                    break
            if buf:
                # pad the tail with its last frame: same chunk shape; the
                # padded frames only touch post-stream tracker state
                submit(buf, metas)
            while inflight:
                consume(inflight.popleft())
        if state_path:
            self.save_runtime_state(state_path, skipped + done, last_ts)
        seconds = time.perf_counter() - t0
        logger.info(f"chunked run processed {done} frames in {seconds:.2f} s")
        p.print_summary()
        return {**p.summary(), "frames": done, "chunks": chunks, "seconds": seconds,
                "fps": done / seconds if seconds > 0 else 0.0}
