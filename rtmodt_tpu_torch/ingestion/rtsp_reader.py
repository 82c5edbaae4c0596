"""Threaded stream reader with latest-frame semantics.

The port's copy of ``rtmodt_tpu/ingestion/rtsp_reader.py``: ``start()`` /
``read()`` / ``read_new()`` / ``stop()`` and a context manager; a daemon
grabber thread that keeps only the newest frame under a lock (frame ids
count up from 1); OpenCV FFmpeg or GStreamer backends; an optional
resolution override; reconnect with capped backoff
(``reconnect_delay * min(n, 5)``, up to ``max_reconnects`` attempts),
interruptible by ``stop()``.

  * ``read()`` and ``read_new()`` return the frame's stream timestamp: for a
    video file ``(POS_FRAMES - 1) / CAP_PROP_FPS``, for a live source the
    wall clock at capture;
  * ``read_new()`` blocks (with a timeout) until an unseen frame id arrives;
  * video files are read in lossless mode (``realtime`` false): the grabber
    waits for each frame to be consumed, so an offline run sees every frame;
    live sources keep only the newest frame.

cv2 is imported where a capture is opened, never at import.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np

from rtmodt_tpu_torch.utils.logging import logger


def _gstreamer_pipeline(source: str, latency: int = 0) -> str:
    return (
        f"rtspsrc location={source} latency={latency} drop-on-latency=true ! "
        "rtph264depay ! h264parse ! decodebin ! videoconvert ! "
        "video/x-raw,format=BGR ! appsink drop=true max-buffers=1"
    )


class RTSPReader:
    """Latest-frame grabber for RTSP/video/webcam sources."""

    def __init__(
        self,
        source: str | int = 0,
        backend: str = "opencv",
        reconnect_delay_sec: float = 2.0,
        max_reconnects: int = 10,
        resolution: Optional[tuple[int, int]] = None,
        target_fps: int = 0,
    ) -> None:
        self.source = source
        self.backend = backend
        self.reconnect_delay_sec = reconnect_delay_sec
        self.max_reconnects = max_reconnects
        self.resolution = tuple(resolution) if resolution else None
        self.target_fps = target_fps

        src_str = str(source)
        self._is_file = not (
            src_str.isdigit()
            or src_str.startswith(("rtsp://", "rtmp://", "http://", "https://", "/dev/"))
        )
        # live sources drop frames to stay live; files are read losslessly
        self.realtime = not self._is_file

        self._cap: Any = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._new_frame = threading.Condition(self._lock)
        self._frame: Optional[np.ndarray] = None
        self._frame_id = 0
        self._frame_ts = 0.0
        self._consumed = threading.Condition(self._lock)
        self._is_consumed = True
        self._running = False
        self._eof = False
        self.fps = 0.0

    # ------------------------------------------------------------------
    def start(self) -> "RTSPReader":
        if self._running:
            return self
        self._open()
        self._running = True
        self._eof = False
        self._thread = threading.Thread(target=self._reader_loop, daemon=True,
                                        name="rtmodt-reader")
        self._thread.start()
        logger.info(f"reader started: {self.source} (file={self._is_file}, "
                    f"realtime={self.realtime}, fps={self.fps:.1f})")
        return self

    def read(self) -> tuple[Optional[np.ndarray], int, float]:
        """Non-blocking: a COPY of the latest frame + its id + stream
        timestamp; (None, last_id, ts) before the first frame arrives."""
        with self._lock:
            if self._frame is None:
                return None, self._frame_id, self._frame_ts
            # reading the latest frame consumes it, or the lossless file
            # grabber would wait forever for a read_new() that never comes
            self._is_consumed = True
            self._consumed.notify_all()
            return self._frame.copy(), self._frame_id, self._frame_ts

    def read_new(self, last_id: int, timeout: float = 1.0
                 ) -> tuple[Optional[np.ndarray], int, float]:
        """Block until a frame newer than ``last_id`` arrives (or timeout/EOF)."""
        deadline = time.monotonic() + timeout
        with self._new_frame:
            while self._frame_id <= last_id and not self._eof and self._running:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._new_frame.wait(remaining):
                    break
            if self._frame is None or self._frame_id <= last_id:
                return None, self._frame_id, self._frame_ts
            self._is_consumed = True
            self._consumed.notify_all()
            return self._frame.copy(), self._frame_id, self._frame_ts

    @property
    def is_eof(self) -> bool:
        return self._eof

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None
        with self._new_frame:
            self._new_frame.notify_all()
        logger.info("reader stopped")

    def __enter__(self) -> "RTSPReader":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    def _open(self) -> None:
        import cv2

        if self.backend == "gstreamer" and not self._is_file:
            self._cap = cv2.VideoCapture(_gstreamer_pipeline(str(self.source)),
                                         cv2.CAP_GSTREAMER)
        else:
            src = int(self.source) if str(self.source).isdigit() else self.source
            self._cap = cv2.VideoCapture(src)
            self._cap.set(cv2.CAP_PROP_BUFFERSIZE, 1)
        if self.resolution:
            self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.resolution[0])
            self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.resolution[1])
        if not self._cap.isOpened():
            raise ConnectionError(f"cannot open source: {self.source}")
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS) or 0.0)

    def _reader_loop(self) -> None:
        import cv2

        reconnects = 0
        frame_interval = 0.0
        if self._is_file and self.realtime is False and self.target_fps:
            frame_interval = 1.0 / self.target_fps
        next_t = time.monotonic()
        while self._running:
            cap = self._cap   # local ref: stop() may null the attribute
            if cap is None or not cap.isOpened():
                if self._is_file:
                    self._eof = True
                    break
                reconnects += 1
                if reconnects > self.max_reconnects:
                    logger.error("max reconnects exceeded; reader giving up")
                    self._eof = True
                    break
                delay = self.reconnect_delay_sec * min(reconnects, 5)
                logger.warning(f"stream lost, reconnect {reconnects}/{self.max_reconnects} "
                               f"in {delay:.1f}s")
                # interruptible backoff: stop() joins with a 2 s timeout, so
                # a multi-second sleep here would leak a capture opened after
                # shutdown
                deadline = time.monotonic() + delay
                while self._running and time.monotonic() < deadline:
                    time.sleep(min(0.1, deadline - time.monotonic()))
                if not self._running:
                    break
                try:
                    self._open()
                except ConnectionError:
                    continue
            cap = self._cap
            if cap is None:
                continue
            ok = cap.grab()
            if not ok:
                if self._is_file:
                    self._eof = True
                    with self._new_frame:
                        self._new_frame.notify_all()
                    break
                cap.release()
                if self._cap is cap:
                    self._cap = None
                continue
            ok, frame = cap.retrieve()
            if not ok or frame is None:
                continue
            reconnects = 0
            ts = time.time()
            if self._is_file and self.fps > 0:
                # stream time for files: frame index / fps.  POS_FRAMES after
                # retrieve() is the NEXT frame's index, so subtract one
                pos = cap.get(cv2.CAP_PROP_POS_FRAMES)
                ts = max(0.0, pos - 1.0) / self.fps
            with self._new_frame:
                if not self.realtime:
                    # lossless mode (video files): wait until the consumer has
                    # taken the previous frame before overwriting it
                    while not self._is_consumed and self._running:
                        self._consumed.wait(timeout=0.1)
                self._frame = frame
                self._frame_id += 1
                self._frame_ts = ts
                self._is_consumed = False
                self._new_frame.notify_all()
            if frame_interval:
                next_t += frame_interval
                sleep = next_t - time.monotonic()
                if sleep > 0:
                    time.sleep(sleep)
        with self._new_frame:
            self._new_frame.notify_all()
