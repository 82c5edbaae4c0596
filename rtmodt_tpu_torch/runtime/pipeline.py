"""The chunked detect -> track -> events pipeline on one stream.

Port of the packed chunk path of ``rtmodt_tpu/runtime/pipeline.py``
(``_packed_chunk_for``, ``submit_packed_yuv``, ``run_chunked``).  Per chunk
of K frames:

  1. the host packs the BGR frames to planar I420 at content size
     (``ops/yuv.py::pack_chunk``) into pinned buffers; the planes go to the
     device with non-blocking copies;
  2. ``planar_letterbox`` -> YOLOv8 (bf16, channels_last on the card) ->
     batched NMS over the K frames (the CUDA NMS kernel) -> boxes back to
     source coordinates;
  3. a sequential ByteTrack update per frame (the only true recurrence);
  4. the (K, S) track outputs come back to pinned host buffers and the host
     runs ``ZoneEventEngine.process_chunk``, for every frame, in order.

``run_chunked`` keeps ``pipeline_depth`` chunks in flight between submit
and consume.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from rtmodt_tpu_torch.config.loader import PipelineConfig, load_config
from rtmodt_tpu_torch.device import resolve_device
from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine
from rtmodt_tpu_torch.models.weights import is_fused, load_into, load_npz
from rtmodt_tpu_torch.models.yolov8 import YOLOv8, build_model
from rtmodt_tpu_torch.ops.letterbox import LetterboxMeta
from rtmodt_tpu_torch.ops.nms import NMSResult, batched_nms_from_logits
from rtmodt_tpu_torch.ops.yuv import (content_dims, pack_chunk, packed_meta,
                                      planar_letterbox, unletterbox_boxes_packed)
from rtmodt_tpu_torch.tracking.bytetrack import (TrackOutputs, bytetrack_update,
                                                 init_track_state)
from rtmodt_tpu_torch.utils.coco_names import COCO_NAMES
from rtmodt_tpu_torch.utils.logging import logger


@torch.no_grad()
def init_random_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """He-normal conv weights, zero biases, identity BN - from ``generator``."""
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            w = torch.randn(m.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.reset_parameters()
            m.reset_running_stats()


def build_detector(cfg: PipelineConfig, device: torch.device, seed: int = 0) -> YOLOv8:
    """The inference model: the weights of ``detection.weights`` (else
    ``fallback_weights``; a reference ``.npz``, BN folded or not), else random
    weights from ``seed``; BN folded when ``fuse_bn``; bf16 when ``half``;
    channels_last on the card."""
    d = cfg.detection
    path = d.weights or d.fallback_weights
    if path:
        logger.info(f"loading weights from {path}")
        flat = load_npz(path)
        if is_fused(flat) and not d.fuse_bn:
            raise ValueError(f"{path} has BN folded (e.g. a QAT checkpoint); "
                             "set detection.fuse_bn: true to load it")
        model = build_model(d.model, d.num_classes, fused=is_fused(flat))
        load_into(model, flat)
    else:
        logger.warning("no weights given - using random initialization from "
                       f"seed {seed} (detections are meaningless)")
        model = build_model(d.model, d.num_classes)
        init_random_(model, torch.Generator().manual_seed(seed))
    model.eval()
    if d.fuse_bn:
        model.fuse_bn()
    model = model.to(device=device, dtype=torch.bfloat16 if d.half else torch.float32)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _frames_from(source: Any) -> Iterator[np.ndarray]:
    """BGR frames of an iterable of arrays, or of a video path / webcam index
    (read with cv2, imported here only)."""
    if not isinstance(source, (str, int)):
        yield from source
        return
    import cv2

    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video source {source!r}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield frame
    finally:
        cap.release()


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
    """One stream end to end on ``device`` (default ``"cuda"``; raises where
    CUDA is absent unless ``device="cpu"`` is asked for)."""

    def __init__(self, cfg: PipelineConfig | None = None, device: str = "cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else load_config()
        d = self.cfg.detection
        self.dtype = torch.bfloat16 if d.half else torch.float32
        self.model = build_detector(self.cfg, self.device, seed)
        self.class_names = list(COCO_NAMES)[: d.num_classes]
        self.class_mask = None
        if d.classes:
            mask = torch.zeros(d.num_classes, dtype=torch.bool)
            mask[list(d.classes)] = True
            self.class_mask = mask.to(self.device)
        self.reset()

    def reset(self) -> None:
        """Start a new stream: empty track slots, fresh zone-event state."""
        self.state = init_track_state(self.cfg.tracking.bytetrack.max_tracks, self.device)
        ev = self.cfg.events
        self.events = (ZoneEventEngine.from_config(ev, trail_length=self.cfg.tracking.trail_length)
                       if ev.enabled and ev.zones else None)
        self.chunks_submitted = 0

    # -- the chunk program -------------------------------------------------
    @torch.no_grad()
    def detect_chunk(self, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     meta: LetterboxMeta) -> NMSResult:
        """Device planes (K, ch, cw) / (K, ch/2, cw/2) uint8 -> detections of
        the K frames in source coordinates."""
        d = self.cfg.detection
        img = planar_letterbox(y, u, v, d.input_size, meta.pad_left, meta.pad_top,
                               dtype=self.dtype)
        # NHWC storage is a channels_last NCHW tensor: no copy
        box_dist, cls_logits = self.model(img.permute(0, 3, 1, 2))
        res = batched_nms_from_logits(
            box_dist, cls_logits, d.input_size, d.conf_threshold, d.iou_threshold,
            d.max_detections, d.nms_candidates, self.class_mask, d.agnostic_nms)
        return res._replace(boxes=unletterbox_boxes_packed(res.boxes, meta))

    @torch.no_grad()
    def track_chunk(self, res: NMSResult) -> TrackOutputs:
        """Sequential ByteTrack over the K frames; outputs stacked (K, S, ...)."""
        outs = []
        for i in range(res.boxes.shape[0]):
            self.state, o = bytetrack_update(self.state, res.boxes[i], res.scores[i],
                                             res.classes[i], res.valid[i],
                                             self.cfg.tracking.bytetrack)
            outs.append(o)
        return TrackOutputs(*(torch.stack(f) for f in zip(*outs)))

    def submit_packed_yuv(self, planes, src_h: int, src_w: int
                          ) -> tuple[TrackOutputs, NMSResult]:
        """Run one chunk: ``planes`` = (y (K, ch, cw), u, v) uint8 as numpy
        arrays or tensors (pinned host tensors copy without blocking).
        Returns the device (TrackOutputs, NMSResult), K leading."""
        meta = packed_meta(src_h, src_w, self.cfg.detection.input_size)
        ch, cw = content_dims(src_h, src_w, self.cfg.detection.input_size)
        y, u, v = (torch.as_tensor(p).to(self.device, non_blocking=True) for p in planes)
        if tuple(y.shape[1:]) != (ch, cw):
            raise ValueError(f"Y planes are {tuple(y.shape[1:])}, expected {(ch, cw)} "
                             f"for {src_w}x{src_h} input")
        res = self.detect_chunk(y, u, v, meta)
        outs = self.track_chunk(res)
        self.chunks_submitted += 1
        return outs, res

    # -- the throughput loop ----------------------------------------------
    def run_chunked(self, source: Iterable[np.ndarray] | str | int,
                    max_frames: int | None = None, fps: float = 30.0) -> dict[str, float]:
        """Detect, track and raise zone events for every frame of ``source``
        (an iterable of BGR frames, a video path or a webcam index), in
        chunks of ``parallel.chunk_size`` (at least 2) with
        ``parallel.pipeline_depth`` chunks in flight.  Frame ids count from
        1; stream time is (id - 1) / ``fps``.  Returns a summary."""
        k = max(2, self.cfg.parallel.chunk_size)
        depth = max(0, self.cfg.parallel.pipeline_depth)
        size = self.cfg.detection.input_size
        s = self.cfg.tracking.bytetrack.max_tracks
        pin = self.device.type == "cuda"
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
                    class_names=self.class_names)
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
            batch = np.stack(frames + [frames[-1]] * (k - len(frames)))
            pack_chunk(batch, size, out=slot.planes)
            outs, _ = self.submit_packed_yuv(slot.planes_t, h, w)
            for dst, src in zip(slot.out, outs):
                dst.copy_(src, non_blocking=pin)
            ready = None
            if pin:
                ready = torch.cuda.Event()
                ready.record()
            inflight.append((metas, slot, ready))
            if len(inflight) > depth:
                consume(inflight.popleft())

        buf: list[np.ndarray] = []
        metas: list = []
        for i, frame in enumerate(_frames_from(source)):
            if max_frames is not None and i >= max_frames:
                break
            buf.append(frame)
            metas.append((i + 1, i / fps))
            if len(buf) == k:
                submit(buf, metas)
                buf, metas = [], []
        if buf:
            # pad the tail with its last frame: same chunk shape; the padded
            # frames only touch post-stream tracker state
            submit(buf, metas)
        while inflight:
            consume(inflight.popleft())
        seconds = time.perf_counter() - t0
        logger.info(f"chunked run processed {done} frames in {seconds:.2f} s")
        return {"frames": done, "chunks": chunks, "seconds": seconds,
                "fps": done / seconds if seconds > 0 else 0.0}
