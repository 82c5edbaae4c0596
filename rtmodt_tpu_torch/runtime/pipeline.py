"""The live pipeline: decode -> detect -> track -> events -> render.

Port of ``rtmodt_tpu/runtime/pipeline.py`` (one stream).  Execution modes:

  * per-stage (``profiling.per_stage: true``, the reference default):
    ``step`` runs the BGR letterbox, the YOLOv8 forward, NMS (the CUDA
    kernel K1 at B = 1) and the ByteTrack update as separate stages, each
    timed by the profiler with a sync of the card; tensors stay on the
    device between stages, only the visible tracks come back to the host;
  * packed per-frame (``per_stage: false``): the host packs each frame to
    planar I420 at content size (``ops/yuv.py::pack_chunk``) and the device
    runs ``planar_letterbox`` -> forward -> NMS -> ByteTrack for it
    (``step_packed``, or ``submit_packed_frame`` with a ``pipeline_depth``
    window in ``run``).  ByteTrack's greedy assignment syncs the host on
    every round (``ops/assignment.py``), so the window holds back only the
    host's half of each frame (events, render) and overlaps no device work;
    a sync-free tracker (ROADMAP item 3) would make it real;
  * chunked (``run_chunked``): K frames per chunk, packed to pinned host
    buffers; the forward and NMS run batched over the chunk, ByteTrack runs
    once per frame in order, and the host runs
    ``ZoneEventEngine.process_chunk`` for every frame.  ``run`` takes this
    path when ``parallel.chunk_size > 1`` and nothing per-frame is asked for
    (no per-stage timing, display, renderer or saved video).

Frames come from the port's ``RTSPReader``: ids count from 1, file frames
carry their stream time, live sources keep only the newest frame.
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
from rtmodt_tpu_torch.detection.detector import Detector, build_detector  # noqa: F401
from rtmodt_tpu_torch.device import config_device, resolve_device
from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine
from rtmodt_tpu_torch.ingestion.rtsp_reader import RTSPReader
from rtmodt_tpu_torch.ops.letterbox import LetterboxMeta
from rtmodt_tpu_torch.ops.nms import NMSResult, batched_nms_from_logits
from rtmodt_tpu_torch.ops.yuv import (content_dims, pack_chunk, packed_meta,
                                      planar_letterbox, unletterbox_boxes_packed)
from rtmodt_tpu_torch.profiling.latency_profiler import LatencyProfiler
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
    """Host buffers of one in-flight chunk: packed input planes and the
    fetched track outputs, pinned on the card's host."""

    def __init__(self, k: int, ch: int, cw: int, s: int, pin: bool):
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
        self.tracker = MultiObjectTracker(
            self.cfg.tracking.algorithm, trail_length=self.cfg.tracking.trail_length,
            device=self.device, bytetrack=self.cfg.tracking.bytetrack)
        v = self.cfg.visualization
        self.renderer = FrameRenderer(
            show_boxes=v.show_boxes, show_labels=v.show_labels,
            show_trails=v.show_trails, show_zones=v.show_zones,
            show_hud=v.show_hud, trail_length=v.trail_length,
        ) if v.enabled else None
        self._per_stage = self.cfg.profiling.per_stage
        self.reset()
        if warmup_shape:
            self.warmup(warmup_shape)

    def reset(self) -> None:
        """Start a new stream: empty track slots, fresh zone-event state, a
        fresh profiler."""
        self.tracker.reset()
        ev = self.cfg.events
        self.events = (ZoneEventEngine.from_config(ev, trail_length=self.cfg.tracking.trail_length)
                       if ev.enabled and ev.zones else None)
        pc = self.cfg.profiling
        self.profiler = LatencyProfiler(enabled=pc.enabled, warmup_frames=pc.warmup_frames,
                                        log_interval=pc.log_interval)
        self.chunks_submitted = 0

    # -- the chunk program -------------------------------------------------
    @torch.no_grad()
    def detect_chunk(self, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     meta: LetterboxMeta) -> NMSResult:
        """Device planes (K, ch, cw) / (K, ch/2, cw/2) uint8 -> detections of
        the K frames in source coordinates."""
        d = self.cfg.detection
        img = planar_letterbox(y, u, v, d.input_size, meta.pad_left, meta.pad_top,
                               dtype=self.detector.dtype)
        # NHWC storage is a channels_last NCHW tensor: no copy
        box_dist, cls_logits = self.detector.model(img.permute(0, 3, 1, 2))
        res = batched_nms_from_logits(
            box_dist, cls_logits, d.input_size, d.conf_threshold, d.iou_threshold,
            d.max_detections, d.nms_candidates, self.detector._class_mask, d.agnostic_nms)
        return res._replace(boxes=unletterbox_boxes_packed(res.boxes, meta))

    @torch.no_grad()
    def track_chunk(self, res: NMSResult) -> TrackOutputs:
        """Sequential ByteTrack over the K frames; outputs stacked (K, S, ...)."""
        outs = [self.tracker.step(res.boxes[i], res.scores[i], res.classes[i], res.valid[i])
                for i in range(res.boxes.shape[0])]
        return TrackOutputs(*(torch.stack(f) for f in zip(*outs)))

    def _packed_program(self, planes, src_h: int, src_w: int
                        ) -> tuple[TrackOutputs, NMSResult]:
        meta = packed_meta(src_h, src_w, self.cfg.detection.input_size)
        ch, cw = content_dims(src_h, src_w, self.cfg.detection.input_size)
        y, u, v = (torch.as_tensor(p).to(self.device, non_blocking=True) for p in planes)
        if tuple(y.shape[1:]) != (ch, cw):
            raise ValueError(f"Y planes are {tuple(y.shape[1:])}, expected {(ch, cw)} "
                             f"for {src_w}x{src_h} input")
        res = self.detect_chunk(y, u, v, meta)
        return self.track_chunk(res), res

    def submit_packed_yuv(self, planes, src_h: int, src_w: int
                          ) -> tuple[TrackOutputs, NMSResult]:
        """Run one chunk: ``planes`` = (y (K, ch, cw), u, v) uint8 as numpy
        arrays or tensors (pinned host tensors copy without blocking).
        Returns the device (TrackOutputs, NMSResult), K leading."""
        out = self._packed_program(planes, src_h, src_w)
        self.chunks_submitted += 1
        return out

    # -- the per-frame paths -------------------------------------------------
    def warmup(self, shape_hw: tuple[int, int], iters: int = 3) -> None:
        """Run the stages of the configured per-frame path on a dummy frame
        (cuDNN picks its algorithms, the allocator fills its pools), then
        reset the tracker: warmup must not leave phantom tracks behind."""
        h, w = shape_hw
        dummy = np.zeros((h, w, 3), np.uint8)
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(iters):
                if self._per_stage:
                    res = self.detector.detect_device(dummy)
                    self.tracker.step(res.boxes, res.scores, res.classes, res.valid)
                else:
                    planes, _ = pack_chunk(dummy[None], self.cfg.detection.input_size)
                    self._packed_program(planes, h, w)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.tracker.reset()
        logger.info(f"pipeline warmup {w}x{h} done in {time.perf_counter() - t0:.1f}s")

    @torch.no_grad()
    def step(self, frame: np.ndarray, frame_id: int, timestamp: float | None = None):
        """Process one BGR frame.  Returns (tracks, events, nms_result).

        Per-stage mode times preprocess, inference, nms and tracking apart,
        each ended by a sync of the card; otherwise the detect + track step is
        timed as one ``inference`` stage."""
        p = self.profiler
        det = self.detector
        h, w = frame.shape[:2]
        if self._per_stage:
            p.tick("preprocess")
            img = det.preprocess(torch.from_numpy(frame).to(self.device))
            p.tock("preprocess", sync_on=img)
            p.tick("inference")
            raw = det.forward(img)
            p.tock("inference", sync_on=raw)
            p.tick("nms")
            res = det.nms(raw, h, w)
            p.tock("nms", sync_on=res)
            p.tick("tracking")
            outputs = self.tracker.step(res.boxes, res.scores, res.classes, res.valid)
            tracks = self.tracker.tracks_from_outputs(outputs, det.class_names)
            p.tock("tracking")
        else:
            p.tick("inference")
            res = det.detect_device(frame)
            outputs = self.tracker.step(res.boxes, res.scores, res.classes, res.valid)
            tracks = self.tracker.tracks_from_outputs(outputs, det.class_names)
            p.tock("inference")
        p.tick("events")
        events = self.events.process(tracks, frame_id, timestamp) if self.events else []
        p.tock("events")
        return tracks, events, res

    def submit_packed_frame(self, frame: np.ndarray) -> tuple[TrackOutputs, NMSResult]:
        """The packed per-frame step up to the tracker's outputs: the host
        packs the frame to planar I420, the device runs the detect + track
        program.  Not asynchronous: the tracker's assignment rounds sync the
        host.  Returns the device (TrackOutputs, NMSResult) of the frame."""
        h, w = frame.shape[:2]
        planes, _ = pack_chunk(frame[None], self.cfg.detection.input_size)
        outs, res = self.submit_packed_yuv(planes, h, w)
        return (TrackOutputs(*(t[0] for t in outs)), NMSResult(*(t[0] for t in res)))

    def step_packed(self, frame: np.ndarray, frame_id: int, timestamp: float | None = None):
        """The packed per-frame path: one frame packed to planar I420 goes
        through ``planar_letterbox`` -> forward -> NMS -> ByteTrack.
        Returns (tracks, events, nms_result)."""
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
            max_frames: int | None = None) -> dict[str, float]:
        """The full CLI loop over ``source`` (a video path, RTSP URL or webcam
        index; default ``ingestion.source``): detect, track, raise zone
        events, render, display and save the annotated video as configured.
        ``max_frames`` of 0 or None means no limit.  Returns the profiler's
        summary."""
        vcfg = self.cfg.visualization
        if (self.cfg.parallel.chunk_size > 1 and not display and not vcfg.save_video
                and self.renderer is None and not self._per_stage):
            return self.run_chunked(source, max_frames)
        import cv2

        reader = self._reader(source)
        writer = None
        zones = self.events.get_zone_polygons() if self.events else []
        names = self.detector.class_names
        depth = 0 if self._per_stage else max(0, self.cfg.parallel.pipeline_depth)
        inflight: deque = deque()
        frames = 0
        p = self.profiler
        warmed = False

        def finish(frame: np.ndarray, tracks: list) -> bool:
            """Render, write and show one frame; False when the user quits."""
            nonlocal writer
            if self.renderer is not None:
                p.tick("visualization")
                self.renderer.render(frame, tracks, zones, fps=p.current_fps,
                                     latency_ms=p.summary().get("total_mean_ms", 0.0))
                p.tock("visualization")
            p.end_frame()
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
            return finish(frame, tracks)

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
                    if not warmed:
                        self.warmup(frame.shape[:2])
                        warmed = True
                    if depth > 0:
                        # submit (the tracker syncs the host, so no device work
                        # overlaps); events and render of the oldest frame wait
                        # until the window is full
                        p.tick("inference")
                        outputs, _ = self.submit_packed_frame(frame)
                        p.tock("inference")
                        inflight.append((frame, fid, ts, outputs))
                        if len(inflight) > depth and not consume(inflight.popleft()):
                            break
                    else:
                        tracks, _, _ = (self.step(frame, fid, ts) if self._per_stage
                                        else self.step_packed(frame, fid, ts))
                        if not finish(frame, tracks):
                            break
                    frames += 1
                    if max_frames and frames >= max_frames:
                        break
                while inflight:  # drain the pipeline window
                    if not consume(inflight.popleft()):
                        break
        except KeyboardInterrupt:
            logger.info("interrupted")
        finally:
            if writer is not None:
                writer.release()
            if display:
                cv2.destroyAllWindows()
        p.print_summary()
        return p.summary()

    # -- the throughput loop ----------------------------------------------
    def run_chunked(self, source: Iterable[np.ndarray] | str | int | None = None,
                    max_frames: int | None = None, fps: float = 30.0) -> dict[str, float]:
        """Detect, track and raise zone events for every frame of ``source``
        in chunks of ``parallel.chunk_size`` (at least 2) with
        ``parallel.pipeline_depth`` chunks in flight.

        ``source`` is a video path, RTSP URL or webcam index (default
        ``ingestion.source``), read through ``RTSPReader`` with its frame ids
        and stream timestamps; or an iterable of BGR frames, whose frame ids
        count from 1 and whose stream time is (id - 1) / ``fps``.
        ``max_frames`` of 0 or None means no limit.  Returns the profiler's
        summary with ``frames``, ``chunks``, ``seconds`` and ``fps``."""
        k = max(2, self.cfg.parallel.chunk_size)
        depth = max(0, self.cfg.parallel.pipeline_depth)
        size = self.cfg.detection.input_size
        s = self.cfg.tracking.bytetrack.max_tracks
        pin = self.device.type == "cuda"
        p = self.profiler
        slots: list[_Slot] = []
        inflight: deque = deque()
        done = chunks = 0
        t0 = time.perf_counter()

        def consume(entry) -> None:
            nonlocal done
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
                    class_names=self.detector.class_names)
            for _ in metas:
                p.end_frame()
            done += n

        def submit(frames: list[np.ndarray], metas: list) -> None:
            nonlocal chunks
            h, w = frames[0].shape[:2]
            if not slots:
                ch, cw = content_dims(h, w, size)
                slots.extend(_Slot(k, ch, cw, s, pin) for _ in range(depth + 1))
            # the slot's previous chunk was consumed (at most `depth` stay in
            # flight), so its host buffers are free to overwrite
            slot = slots[chunks % len(slots)]
            chunks += 1
            p.tick("inference")
            batch = np.stack(frames + [frames[-1]] * (k - len(frames)))
            pack_chunk(batch, size, out=slot.planes)
            outs, _ = self.submit_packed_yuv(slot.planes_t, h, w)
            for dst, src in zip(slot.out, outs):
                dst.copy_(src, non_blocking=pin)
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
        with reader if reader is not None else contextlib.nullcontext():
            stream = (_reader_frames(reader) if reader is not None else
                      ((frame, i + 1, i / fps) for i, frame in enumerate(source)))
            buf: list[np.ndarray] = []
            metas: list = []
            read = 0
            for frame, fid, ts in stream:
                buf.append(frame)
                metas.append((fid, ts))
                read += 1
                if len(buf) == k:
                    submit(buf, metas)
                    buf, metas = [], []
                if max_frames and read >= max_frames:
                    break
            if buf:
                # pad the tail with its last frame: same chunk shape; the
                # padded frames only touch post-stream tracker state
                submit(buf, metas)
            while inflight:
                consume(inflight.popleft())
        seconds = time.perf_counter() - t0
        logger.info(f"chunked run processed {done} frames in {seconds:.2f} s")
        p.print_summary()
        return {**p.summary(), "frames": done, "chunks": chunks, "seconds": seconds,
                "fps": done / seconds if seconds > 0 else 0.0}
