"""Live MJPEG monitor for a running pipeline.

The port's copy of ``rtmodt_tpu/serving/monitor.py``.  The CLI's only
other live view is a local ``cv2.imshow`` window (``--display``), which is
useless on a headless GPU host.  This module serves the pipeline's
annotated frames over HTTP instead: point any browser at
``http://host:port/`` while the CLI runs with ``--mjpeg-port`` and watch the
stream live - no X11, no client software, multiple concurrent viewers.

Design for the hot path:

* ``publish()`` is O(1) and lock-light: it stores one copy of the frame,
  latest-wins (a slow viewer never backpressures the pipeline - same
  discipline as the RTSP reader's latest-frame buffer,
  ingestion/rtsp_reader.py), and nudges waiting viewers via a condition
  variable.
* JPEG encoding happens on the VIEWER's thread, once per published frame
  (cached by sequence number) no matter how many viewers are attached.
"""

from __future__ import annotations

import threading
from typing import Iterator

import numpy as np

from rtmodt_tpu_torch.serving.wsgi import (
    App,
    HTTPError,
    Request,
    Response,
    StreamingResponse,
    _QuietHandler,
    _ThreadingWSGIServer,
)
from rtmodt_tpu_torch.utils.logging import logger

_BOUNDARY = "rtmodtlive"

_INDEX_HTML = """<!DOCTYPE html>
<html><head><title>RTMODT live monitor</title>
<style>body{margin:0;background:#0d1117;display:flex;align-items:center;
justify-content:center;min-height:100vh}img{max-width:100vw;max-height:100vh}
</style></head>
<body><img src="/stream" alt="live pipeline stream"></body></html>
"""


class LiveMonitor:
    """Threaded HTTP server streaming the latest published frame as MJPEG.

    ``GET /``       - minimal viewer page (just an ``<img src=/stream>``)
    ``GET /stream`` - ``multipart/x-mixed-replace`` JPEG stream
    ``GET /frame``  - single current frame as ``image/jpeg`` (poll-friendly)
    """

    def __init__(self, port: int, host: str = "0.0.0.0",
                 quality: int = 80, max_fps: float = 30.0):
        self._cond = threading.Condition()
        self._frame: np.ndarray | None = None     # latest published (BGR)
        self._seq = 0
        self._jpeg: tuple[int, bytes] | None = None   # (seq, encoded) cache
        self._viewers = 0
        self._closed = False
        self._quality = int(quality)
        self._min_period = 1.0 / max_fps if max_fps > 0 else 0.0

        app = App()
        app.get("/")(lambda req: Response(_INDEX_HTML, 200,
                                          "text/html; charset=utf-8"))
        app.get("/stream")(self._route_stream)
        app.get("/frame")(self._route_frame)
        from wsgiref.simple_server import make_server

        self._httpd = make_server(host, port, app,
                                  server_class=_ThreadingWSGIServer,
                                  handler_class=_QuietHandler)
        self.port = self._httpd.server_address[1]   # resolved (port=0 -> OS pick)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="rtmodt-monitor", daemon=True)
        self._thread.start()
        logger.info(f"live monitor on http://{host}:{self.port}/")

    # ---------------------------------------------------------- hot path
    def publish(self, frame_bgr: np.ndarray) -> None:
        """Hand the monitor one annotated frame; returns immediately.

        The latest frame is stored unconditionally so a client that only
        polls ``GET /frame`` (no ``/stream`` connection holding a viewer
        slot) still gets a picture; one small copy per frame is cheap next
        to the render that just produced it.  JPEG encoding stays lazy
        (per request / per stream yield), so a headless run pays only the
        copy.
        """
        if self._closed:
            return
        with self._cond:
            self._frame = frame_bgr.copy()
            self._seq += 1
            self._cond.notify_all()

    # ------------------------------------------------------------ routes
    def _encode(self, seq: int, frame: np.ndarray) -> bytes:
        """Encode ``frame`` once per sequence number, shared by viewers."""
        import cv2

        with self._cond:
            if self._jpeg is not None and self._jpeg[0] == seq:
                return self._jpeg[1]
        ok, buf = cv2.imencode(
            ".jpg", frame, [int(cv2.IMWRITE_JPEG_QUALITY), self._quality])
        data = buf.tobytes() if ok else b""
        with self._cond:
            if self._jpeg is None or self._jpeg[0] < seq:
                self._jpeg = (seq, data)
        return data

    def _route_frame(self, req: Request) -> Response:
        with self._cond:
            frame, seq = self._frame, self._seq
        if frame is None:
            raise HTTPError(404, "no frame published yet")
        return Response(self._encode(seq, frame), 200, "image/jpeg")

    def _route_stream(self, req: Request) -> StreamingResponse:
        return StreamingResponse(
            self._stream_iter(),
            content_type=f"multipart/x-mixed-replace; boundary={_BOUNDARY}",
            headers=[("Cache-Control", "no-cache")])

    def _stream_iter(self) -> Iterator[bytes]:
        import time

        with self._cond:
            self._viewers += 1
        last_seq = 0
        last_yield = 0.0
        try:
            # multipart preamble (ignored by parsers, RFC 2046): forces the
            # WSGI layer to transmit the response headers at connect time,
            # before the first frame is published - otherwise clients block
            # waiting for headers on an idle pipeline
            yield b"\r\n"
            while True:
                with self._cond:
                    if self._seq == last_seq and not self._closed:
                        self._cond.wait(timeout=1.0)
                    if self._closed:
                        break
                    if self._seq == last_seq:
                        continue            # timeout tick: nothing new yet
                    frame, last_seq = self._frame, self._seq
                # pace per-viewer outside the lock
                now = time.monotonic()
                if now - last_yield < self._min_period:
                    time.sleep(self._min_period - (now - last_yield))
                last_yield = time.monotonic()
                jpg = self._encode(last_seq, frame)
                if jpg:
                    yield (f"--{_BOUNDARY}\r\nContent-Type: image/jpeg\r\n"
                           f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                           + jpg + b"\r\n")
            yield f"--{_BOUNDARY}--\r\n".encode()
        finally:
            with self._cond:
                self._viewers -= 1

    # ----------------------------------------------------------- teardown
    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
