"""Web demo server on the PyTorch/CUDA port.

The port's copy of ``rtmodt_tpu/serving/server.py``: the same HTTP surface,
status codes, limits and JSON keys, so that the SPA in ``web/static`` works
unchanged against it:

  GET  /                            -> SPA index.html
  GET  /static/...                  -> static assets (incl. /static/samples)
  GET  /api/samples                 -> {"samples": [{name, filename, url}]}
  POST /api/detect/image            -> multipart upload, 400 on bad image
  POST /api/detect/frame            -> {"image": dataURL-base64}, 400 on bad data;
                                       ``session_id`` / ``algorithm`` / ``zones``
  GET  /api/detect/sample/{file}    -> 404 if missing
  POST /api/track/video             -> per-frame tracks (+ zone events) of a clip
  GET  /api/stream/demo             -> annotated MJPEG of the synthetic scene
  POST /api/stream/video            -> annotated MJPEG of an uploaded clip
  GET  /api/health                  -> {status, backend, devices}

Detection responses: ``{detections: [{bbox, confidence, class_id,
class_name}], tracks, inference_ms, num_objects, image_size: [w, h]}``.

Inference runs the port's ``Detector`` (YOLOv8, NMS with the CUDA kernel K1
once per frame) built lazily on the card from ``RTMODT_MODEL`` /
``RTMODT_WEIGHTS`` (a reference ``.npz`` or an ultralytics ``.pt`` /
``.pth``, ``models/weights.py::load_params``); without a card the first request fails (HTTP 500)
unless a caller has injected a detector with ``_singleton.set``.  Every
tracker the server builds lives on the served detector's device.  Serving
is the stdlib WSGI stack in ``wsgi.py``, a thread per request; the
detector and tracker calls of every request run on one long-lived device
thread (``_device``), a session's tracker is updated under its lock,
and the video route's cached trackers under theirs.
"""

from __future__ import annotations

import base64
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

from rtmodt_tpu_torch.serving.wsgi import (
    App,
    HTTPError,
    JSONResponse,
    Request,
    Response,
    StreamingResponse,
    static_response,
)
from rtmodt_tpu_torch.utils.coco_names import COCO_NAMES
from rtmodt_tpu_torch.utils.logging import logger

WEB_DIR = Path(os.environ.get(
    "RTMODT_WEB_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "web")))
STATIC_DIR = WEB_DIR / "static"
SAMPLES_DIR = STATIC_DIR / "samples"


class _DetectorSingleton:
    """Lazy, thread-safe detector: built on the card at the first request
    (it raises where CUDA is absent); ``set`` injects another one, e.g. a
    CPU ``Detector`` in tests."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._detector = None

    def get(self):
        with self._lock:
            if self._detector is None:
                from rtmodt_tpu_torch.config.loader import DetectionConfig
                from rtmodt_tpu_torch.detection.detector import Detector

                weights = os.environ.get("RTMODT_WEIGHTS")
                logger.info("loading web detector (first request)...")
                self._detector = Detector(
                    DetectionConfig(
                        model=os.environ.get("RTMODT_MODEL", "yolov8s"),
                        weights=weights,
                        conf_threshold=0.35,
                        iou_threshold=0.45,
                        classes=None,
                    ),
                    device="cuda",
                    warmup=False,
                )
            return self._detector

    def loaded(self):
        """The detector being served, or None before the first request."""
        with self._lock:
            return self._detector

    def set(self, detector) -> None:
        with self._lock:
            self._detector = detector


_singleton = _DetectorSingleton()


# The one long-lived thread that runs every detector and tracker call of the
# server, in arrival order.  The WSGI server handles each request on a new
# thread, and PyTorch keeps cuDNN's execution plans per thread: on a thread
# that has not run the model yet, every convolution plans again, and one 720p
# frame's detection took 117 ms instead of 8 (NVIDIA H100 80GB HBM3, 700 W;
# ``chip_smoke.py`` phase 9 (e)).  Request threads keep the host work
# (decoding, zone events, encoding); the device work is submitted here.
_device = ThreadPoolExecutor(max_workers=1, thread_name_prefix="rtmodt-device")


def _track_frame(detector, tracker, frame: np.ndarray) -> list:
    """Detect and track one BGR frame on the device thread."""
    return _device.submit(lambda: tracker.update(detector.detect(frame), frame)).result()


_ALGORITHMS = ("bytetrack", "deepsort", "botsort", "ocsort")


def _check_algorithm(algo) -> str | None:
    """Validate a client-supplied tracker name; None passes through
    (meaning: keep the session's current algorithm / use the default)."""
    if algo is None:
        return None
    algo = str(algo).lower()
    if algo not in _ALGORITHMS:
        raise HTTPError(400, f"algorithm must be one of {'|'.join(_ALGORITHMS)}")
    return algo


class _Session:
    """One webcam client's server-side state: tracker + optional zone engine."""

    __slots__ = ("tracker", "engine", "zones_sig", "zone_polys", "frame_id",
                 "lock", "algorithm")

    def __init__(self, algorithm: str, device: torch.device):
        from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker

        self.algorithm = algorithm
        self.tracker = MultiObjectTracker(algorithm, device=device)
        self.engine = None
        self.zones_sig: str | None = None
        self.zone_polys: list | None = None   # cached echo for responses
        self.frame_id = 0
        # serializes tracker/engine updates when two requests share an id
        self.lock = threading.Lock()

    def set_zones(self, specs) -> None:
        """(Re)configure zones from decoded JSON; None clears.  Live frames
        use wall-clock dwell (the reference's zone semantics for live
        streams, ref zone_engine.py:84).  Validation happens BEFORE any
        state changes: a rejected payload leaves the previous engine (and
        its dwell/cooldown state) untouched, and the same bad payload keeps
        failing with 400 instead of matching a stored signature."""
        import json as _json

        from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine

        sig = _json.dumps(specs, sort_keys=True) if specs is not None else None
        if sig == self.zones_sig:
            return
        engine = None
        polys = None
        if specs is not None:
            engine = ZoneEventEngine(
                _parse_zone_specs(specs),        # raises HTTPError(400)
                log_path="logs/web_events.jsonl", clock="wall")
            polys = [{"name": z.name, "polygon": z.polygon.tolist()}
                     for z in engine.zones]
        self.zones_sig = sig
        self.engine = engine
        self.zone_polys = polys


class _TrackerSessions:
    """Per-client tracker state for the webcam loop.

    The reference's web path never tracks (``tracks`` is always ``[]``,
    web/server.py:111); here a client that sends a ``session_id`` with its
    frames gets persistent-ID tracks + trails across requests, and live
    zone-intrusion alerts when it also sends ``zones``.  Sessions expire
    after ``ttl`` seconds idle.
    """

    def __init__(self, ttl: float = 120.0, max_sessions: int = 32):
        self._lock = threading.Lock()
        self._sessions: dict[str, tuple[float, _Session]] = {}
        self.ttl = ttl
        self.max_sessions = max_sessions

    def get(self, session_id: str, algorithm: str | None,
            device: torch.device) -> _Session:
        """``algorithm=None`` keeps an existing session's tracker (a frame
        that omits the field must not reset a non-default session).  A
        session whose tracker is on another device than ``device`` (the
        served detector's) restarts there."""
        now = time.time()
        with self._lock:
            for sid in [s for s, (t, _) in self._sessions.items()
                        if now - t > self.ttl]:
                del self._sessions[sid]
            existing = self._sessions.get(session_id)
            if existing is not None and existing[1].tracker.device == device and (
                    algorithm is None
                    or existing[1].algorithm == algorithm):
                self._sessions[session_id] = (now, existing[1])
                return existing[1]
        # construct OUTSIDE the lock: deepsort/botsort init loads embedder
        # weights and would stall every other client's frame for seconds
        sess = _Session(algorithm or "bytetrack", device)
        with self._lock:
            cur = self._sessions.get(session_id)
            if (cur is not None and cur[1].algorithm == sess.algorithm
                    and cur[1].tracker.device == device):
                sess = cur[1]     # raced with another first-frame: keep one
            elif session_id not in self._sessions \
                    and len(self._sessions) >= self.max_sessions:
                oldest = min(self._sessions, key=lambda s: self._sessions[s][0])
                del self._sessions[oldest]
            self._sessions[session_id] = (now, sess)
            return sess


_sessions = _TrackerSessions()


class _VideoTrackers:
    """Tracker cache for /api/track/video: constructing an appearance
    tracker (embedder weights) per request would cost a weight load per
    upload.  One cached tracker per (algorithm, device), reset per clip, so
    a detector injected on another device never gets a tracker on the old
    one; the per-tracker lock serializes concurrent uploads of the same
    key (they share mutable state)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._trackers: dict[tuple[str, torch.device], tuple[threading.Lock, object]] = {}

    def acquire(self, algorithm: str, device: torch.device):
        from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker

        key = (algorithm, device)
        with self._lock:
            entry = self._trackers.get(key)
        if entry is None:
            tracker = MultiObjectTracker(algorithm, device=device)   # outside the dict lock
            with self._lock:
                entry = self._trackers.setdefault(key, (threading.Lock(), tracker))
        return entry


_video_trackers = _VideoTrackers()


def _run_detection(img_bgr: np.ndarray, session_id: str | None = None,
                   zones=None, algorithm: str | None = None) -> dict:
    """Single-image detection -> reference response schema
    (web/server.py:84-115).  With a ``session_id``, detections also flow
    through a per-session tracker (``algorithm``: bytetrack | deepsort |
    botsort | ocsort) and ``tracks`` is populated; with ``zones`` too
    (decoded JSON list), the session runs a wall-clock zone-event engine
    and this frame's alerts are returned."""
    detector = _singleton.get()
    t0 = time.perf_counter()
    det = _device.submit(detector.detect, img_bgr).result()
    inference_ms = (time.perf_counter() - t0) * 1e3
    detections = [
        {
            "bbox": [float(v) for v in det.xyxy[i]],
            "confidence": float(det.confidence[i]),
            "class_id": int(det.class_id[i]),
            "class_name": (det.class_names[det.class_id[i]]
                           if 0 <= det.class_id[i] < len(det.class_names)
                           else COCO_NAMES[det.class_id[i] % len(COCO_NAMES)]),
        }
        for i in range(len(det))
    ]
    tracks = []
    events = zone_polys = None
    sess = None
    if session_id:
        sess = _sessions.get(session_id, algorithm, detector.device)
        with sess.lock:
            sess.frame_id += 1
            sess.set_zones(zones)
            # the frame feeds appearance embeddings (deepsort/botsort) and
            # camera-motion estimation; bytetrack/ocsort ignore it
            live = _device.submit(sess.tracker.update, det, img_bgr).result()
            if sess.engine is not None:
                events = [asdict(ev)
                          for ev in sess.engine.process(live, sess.frame_id)]
                zone_polys = sess.zone_polys
        for t in live:
            tracks.append({
                "track_id": int(t.track_id),
                "bbox": [float(v) for v in t.xyxy],
                "confidence": float(t.confidence),
                "class_id": int(t.class_id),
                "class_name": t.class_name,
                "age": int(t.age),
                "trail": [[int(x), int(y)] for x, y in t.trail],
            })
    h, w = img_bgr.shape[:2]
    resp = {
        "detections": detections,
        "tracks": tracks,
        "inference_ms": round(inference_ms, 2),
        "num_objects": len(detections),
        "image_size": [w, h],
    }
    if events is not None:
        resp["events"] = events
        resp["zones"] = zone_polys
    return resp


def _decode_image(data: bytes) -> np.ndarray:
    import cv2

    arr = np.frombuffer(data, np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
    if img is None:
        raise HTTPError(400, "Could not decode image.")
    return img


def _parse_zone_specs(specs) -> list[dict]:
    """Validate user-supplied zone specs (already-decoded JSON).

    Web-demo defaults differ from the pipeline config: dwell 0 s (fire on
    entry - uploaded clips are seconds long) and cooldown 2 s.  All input is
    validated; anything malformed is a 400, never a traceback.
    """
    if not isinstance(specs, list) or not specs:
        raise HTTPError(400, "zones must be a non-empty JSON list")
    if len(specs) > 8:
        raise HTTPError(400, "at most 8 zones per request")
    cleaned = []
    for i, z in enumerate(specs):
        if not isinstance(z, dict):
            raise HTTPError(400, f"zones[{i}] must be an object")
        poly = z.get("polygon")
        if (not isinstance(poly, list) or not 3 <= len(poly) <= 32
                or not all(isinstance(p, (list, tuple)) and len(p) == 2
                           and all(isinstance(v, (int, float))
                                   and not isinstance(v, bool)
                                   and math.isfinite(v) for v in p)
                           for p in poly)):
            raise HTTPError(400, f"zones[{i}].polygon must be 3-32 finite [x, y] pairs")

        def _num(key, default):
            v = z.get(key, default)
            if (not isinstance(v, (int, float)) or isinstance(v, bool)
                    or not math.isfinite(v) or v < 0):
                raise HTTPError(400, f"zones[{i}].{key} must be a finite number >= 0")
            return float(v)

        spec = {
            "name": str(z.get("name", f"zone-{i + 1}"))[:64],
            "polygon": [[float(x), float(y)] for x, y in poly],
            "dwell_time_sec": _num("dwell_time_sec", 0.0),
            "cooldown_sec": _num("cooldown_sec", 2.0),
            "trigger": str(z.get("trigger", "intrusion")),
        }
        if spec["trigger"] not in ("intrusion", "crossing"):
            raise HTTPError(400, f"zones[{i}].trigger must be intrusion|crossing")
        if z.get("direction") is not None:
            spec["direction"] = str(z["direction"])
        if z.get("classes") is not None:
            cls = z["classes"]
            if not isinstance(cls, list) or not all(isinstance(c, int) for c in cls):
                raise HTTPError(400, f"zones[{i}].classes must be a list of ints")
            spec["classes"] = cls
        cleaned.append(spec)
    names = [s["name"] for s in cleaned]
    if len(set(names)) != len(names):
        # the engine keys dwell/cooldown by zone name; duplicates would
        # corrupt each other's state (one zone's exit pops the other's entry)
        raise HTTPError(400, "zone names must be unique")
    return cleaned


_MJPEG_BOUNDARY = "rtmodtframe"


def _mjpeg_part(jpg: bytes) -> bytes:
    return (f"--{_MJPEG_BOUNDARY}\r\nContent-Type: image/jpeg\r\n"
            f"Content-Length: {len(jpg)}\r\n\r\n".encode() + jpg + b"\r\n")


def _clamp_num(q: dict, key: str, default: float, lo: float, hi: float) -> float:
    try:
        v = float(q.get(key, default))
    except (TypeError, ValueError):
        raise HTTPError(400, f"{key} must be a number")
    # NaN slips through min/max (min(max(nan, lo), hi) stays NaN) and then
    # explodes downstream - int(nan) -> 500, or worse inside a streaming
    # generator after the 200 status line is already sent
    if not math.isfinite(v):
        raise HTTPError(400, f"{key} must be a finite number")
    return min(max(v, lo), hi)


class _UnlinkOnClose:
    """Streaming-body wrapper that guarantees a backing tempfile is removed
    on ``close()``.  A bare generator's ``finally`` never runs when the WSGI
    server closes it BEFORE its first iteration (client disconnects between
    headers and first frame: ``gen.close()`` on an unstarted generator skips
    the body entirely), which would leak the file."""

    def __init__(self, gen, path: str):
        self._gen, self._path = gen, path

    def __iter__(self):
        return iter(self._gen)

    def close(self) -> None:
        try:
            close = getattr(self._gen, "close", None)
            if close is not None:
                close()
        finally:
            try:
                os.unlink(self._path)
            except OSError:
                pass


def _annotate_tracked(renderer, frame: np.ndarray, tracks, fps: float,
                      latency_ms: float) -> bytes:
    """Render tracks onto a frame and JPEG-encode it for an MJPEG part."""
    import cv2

    renderer.render(frame, tracks, fps=fps, latency_ms=latency_ms)
    ok, jpg = cv2.imencode(".jpg", frame, [int(cv2.IMWRITE_JPEG_QUALITY), 80])
    if not ok:  # pragma: no cover - imencode only fails on invalid input
        raise RuntimeError("JPEG encode failed")
    return jpg.tobytes()


def _build_zone_engine(raw: bytes, clock: str = "stream"):
    """Decode + validate a ``zones`` multipart field into a ZoneEventEngine."""
    import json as _json

    from rtmodt_tpu_torch.events.zone_engine import ZoneEventEngine

    try:
        specs = _json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        raise HTTPError(400, "zones must be valid JSON")
    return ZoneEventEngine(_parse_zone_specs(specs),
                           log_path="logs/web_events.jsonl", clock=clock)


def create_app() -> App:
    app = App()
    STATIC_DIR.mkdir(parents=True, exist_ok=True)
    SAMPLES_DIR.mkdir(parents=True, exist_ok=True)

    @app.get("/")
    def index(req: Request) -> Response:
        p = WEB_DIR / "index.html"
        if not p.exists():
            raise HTTPError(404, "index.html missing")
        return Response(p.read_bytes(), 200, "text/html; charset=utf-8")

    @app.get("/static/{path}")
    def static_one(req: Request) -> Response:
        return static_response(str(STATIC_DIR / req.path_params["path"]))

    @app.get("/static/{dir}/{path}")
    def static_two(req: Request) -> Response:
        return static_response(
            str(STATIC_DIR / req.path_params["dir"] / req.path_params["path"]))

    @app.get("/api/samples")
    def list_samples(req: Request) -> Response:
        samples = []
        if SAMPLES_DIR.exists():
            for f in sorted(SAMPLES_DIR.iterdir()):
                if f.suffix.lower() in (".jpg", ".jpeg", ".png", ".webp"):
                    samples.append({
                        "name": f.stem.replace("_", " ").title(),
                        "filename": f.name,
                        "url": f"/static/samples/{f.name}",
                    })
        return JSONResponse({"samples": samples})

    @app.post("/api/detect/image")
    def detect_image(req: Request) -> Response:
        files = req.files()
        if "file" not in files:
            raise HTTPError(400, "missing multipart field 'file'")
        _, content = files["file"]
        return JSONResponse(_run_detection(_decode_image(content)))

    @app.post("/api/detect/frame")
    def detect_frame(req: Request) -> Response:
        try:
            payload = req.json()
        except Exception:
            raise HTTPError(400, "invalid JSON body")
        data_url = str(payload.get("image", ""))
        if "," in data_url:
            data_url = data_url.split(",", 1)[1]
        try:
            img_bytes = base64.b64decode(data_url, validate=True)
        except Exception:
            raise HTTPError(400, "Invalid base64 image data.")
        session_id = payload.get("session_id") or None
        if session_id is not None:
            session_id = str(session_id)[:64]
        zones = payload.get("zones")
        if zones is not None and session_id is None:
            raise HTTPError(400, "zones require a session_id")
        algo = _check_algorithm(payload.get("algorithm"))
        return JSONResponse(_run_detection(_decode_image(img_bytes),
                                           session_id, zones, algo))

    @app.post("/api/track/video")
    def track_video(req: Request) -> Response:
        """Server-side detect+track over an uploaded video clip.

        The reference SPA only grabs ONE frame from uploaded videos
        (web/static/app.js capture-at-t=0.5s path); this endpoint runs the
        real tracker over the clip and returns per-frame persistent-ID
        tracks.  Query/body knobs: ``max_frames`` (default 150, cap 600),
        ``stride`` (process every Nth frame, default 1), ``algorithm``
        (bytetrack | deepsort | botsort | ocsort, default bytetrack).

        An optional ``zones`` multipart field (JSON list of
        ``{name, polygon: [[x, y], ...], dwell_time_sec?, cooldown_sec?,
        trigger?, direction?, classes?}``) runs the zone-event engine over
        the tracked clip on stream time and returns the fired events - the
        full events subsystem on the demo surface, not just detect+track.
        """
        import tempfile

        import cv2

        files = req.files()
        if "file" not in files:
            raise HTTPError(400, "missing multipart field 'file'")
        filename, content = files["file"]
        if len(content) > 64 * 1024 * 1024:
            raise HTTPError(413, "video too large (64 MB limit)")
        try:
            max_frames = min(max(1, int(req.query.get("max_frames", 150))), 600)
            stride = max(1, int(req.query.get("stride", 1)))
        except (TypeError, ValueError):
            raise HTTPError(400, "max_frames/stride must be integers")
        zone_engine = None
        if "zones" in files:
            zone_engine = _build_zone_engine(files["zones"][1])

        suffix = os.path.splitext(filename or "clip.mp4")[1] or ".mp4"
        detector = _singleton.get()
        algo = _check_algorithm(req.query.get("algorithm")) or "bytetrack"
        tracker_lock, tracker = _video_trackers.acquire(algo, detector.device)
        t0 = time.perf_counter()
        events_out = []
        frames_out = []
        n_read = 0
        track_ids = set()
        with tracker_lock, tempfile.NamedTemporaryFile(suffix=suffix) as tmp:
            tracker.reset()
            tmp.write(content)
            tmp.flush()
            cap = cv2.VideoCapture(tmp.name)
            if not cap.isOpened():
                raise HTTPError(400, "Could not decode video.")
            try:
                fps_in = cap.get(cv2.CAP_PROP_FPS) or 0.0
                size = None
                while len(frames_out) < max_frames:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    n_read += 1
                    if (n_read - 1) % stride:
                        continue
                    size = (frame.shape[1], frame.shape[0])
                    live = _track_frame(detector, tracker, frame)
                    if zone_engine is not None:
                        ts = n_read / fps_in if fps_in > 0 else float(n_read) / 25.0
                        for ev in zone_engine.process(live, n_read, timestamp=ts):
                            events_out.append(asdict(ev))
                    tracks = []
                    for t in live:
                        track_ids.add(int(t.track_id))
                        tracks.append({
                            "track_id": int(t.track_id),
                            "bbox": [float(v) for v in t.xyxy],
                            "confidence": float(t.confidence),
                            "class_id": int(t.class_id),
                            "class_name": t.class_name,
                        })
                    frames_out.append({"frame_id": n_read, "tracks": tracks})
            finally:
                cap.release()
        if not frames_out:
            raise HTTPError(400, "Could not decode video.")
        wall = time.perf_counter() - t0
        resp = {
            "frames": frames_out,
            "num_frames": len(frames_out),
            "num_tracks": len(track_ids),
            "video_fps": round(float(fps_in), 2),
            "processing_fps": round(len(frames_out) / wall, 1) if wall else 0.0,
            "image_size": list(size) if size else None,
        }
        if zone_engine is not None:
            resp["events"] = events_out
            resp["zones"] = [{"name": z.name, "polygon": z.polygon.tolist()}
                             for z in zone_engine.zones]
            resp["zone_counts"] = zone_engine.zone_counts()
        return JSONResponse(resp)

    @app.get("/api/stream/demo")
    def stream_demo(req: Request) -> Response:
        """Live annotated MJPEG stream (``multipart/x-mixed-replace``) of the
        framework's deterministic synthetic scene run through the real
        detect -> track -> render path - the "Real-Time" part of the demo,
        viewable as a plain ``<img src=...>``.

        The reference has no live-stream endpoint (its SPA polls single
        frames, web/static/app.js); this is a serving extension.  Query
        knobs: ``algorithm`` (bytetrack | deepsort | botsort | ocsort),
        ``seconds`` (stream length, default 15, cap 120), ``fps`` (pace,
        default 10, cap 30), ``objects`` (scene density, default 6, cap 16).
        """
        from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker
        from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame
        from rtmodt_tpu_torch.visualization.renderer import FrameRenderer

        q = req.query
        algo = _check_algorithm(q.get("algorithm")) or "bytetrack"
        seconds = _clamp_num(q, "seconds", 15.0, 0.1, 120.0)
        fps = _clamp_num(q, "fps", 10.0, 1.0, 30.0)
        n_objects = int(_clamp_num(q, "objects", 6, 1, 16))
        detector = _singleton.get()       # build before streaming starts
        tracker = MultiObjectTracker(algo, device=detector.device)
        renderer = FrameRenderer(show_hud=True)

        def produce():
            period = 1.0 / fps
            t_next = time.perf_counter()
            for t in range(max(1, int(seconds * fps))):
                t0 = time.perf_counter()
                frame, _ = moving_boxes_frame(t, 480, 640, n_objects=n_objects)
                live = _track_frame(detector, tracker, frame)
                ms = (time.perf_counter() - t0) * 1e3
                yield _mjpeg_part(_annotate_tracked(
                    renderer, frame, live, fps=min(fps, 1e3 / max(ms, 1e-6)),
                    latency_ms=ms))
                t_next += period
                delay = t_next - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            yield f"--{_MJPEG_BOUNDARY}--\r\n".encode()

        return StreamingResponse(
            produce(),
            content_type=f"multipart/x-mixed-replace; boundary={_MJPEG_BOUNDARY}",
            headers=[("Cache-Control", "no-cache")])

    @app.post("/api/stream/video")
    def stream_video(req: Request) -> Response:
        """Upload a video clip, receive an annotated MJPEG stream back: each
        frame runs detect -> track server-side and is returned with boxes,
        IDs, and trails drawn - the streaming twin of ``/api/track/video``
        (which returns JSON).  Query knobs: ``algorithm``, ``max_frames``
        (default 300, cap 1200), ``stride``.  Frames are streamed as fast
        as they are processed (no pacing): clients render at arrival rate.
        """
        import tempfile

        import cv2

        from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker
        from rtmodt_tpu_torch.visualization.renderer import FrameRenderer

        files = req.files()
        if "file" not in files:
            raise HTTPError(400, "missing multipart field 'file'")
        filename, content = files["file"]
        if len(content) > 64 * 1024 * 1024:
            raise HTTPError(413, "video too large (64 MB limit)")
        q = req.query
        max_frames = int(_clamp_num(q, "max_frames", 300, 1, 1200))
        stride = int(_clamp_num(q, "stride", 1, 1, 64))
        algo = _check_algorithm(q.get("algorithm")) or "bytetrack"
        detector = _singleton.get()
        tracker = MultiObjectTracker(algo, device=detector.device)
        renderer = FrameRenderer(show_hud=True)

        # validate the clip decodes BEFORE committing to a 200 streaming
        # response (a mid-stream failure cannot change the status line);
        # any pre-stream failure (not just HTTPError - e.g. OSError on the
        # tmp write) must unlink, so catch everything and re-raise
        suffix = os.path.splitext(filename or "clip.mp4")[1] or ".mp4"
        tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
        try:
            tmp.write(content)
            tmp.close()
            cap = cv2.VideoCapture(tmp.name)
            if not cap.isOpened() or not cap.read()[0]:
                cap.release()
                raise HTTPError(400, "Could not decode video.")
            cap.release()
        except BaseException:
            os.unlink(tmp.name)
            raise

        def produce():
            cap = cv2.VideoCapture(tmp.name)
            t_start = time.perf_counter()
            n_read = n_out = 0
            try:
                while n_out < max_frames:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    n_read += 1
                    if (n_read - 1) % stride:
                        continue
                    t0 = time.perf_counter()
                    live = _track_frame(detector, tracker, frame)
                    ms = (time.perf_counter() - t0) * 1e3
                    n_out += 1
                    yield _mjpeg_part(_annotate_tracked(
                        renderer, frame, live,
                        fps=n_out / max(time.perf_counter() - t_start, 1e-6),
                        latency_ms=ms))
                yield f"--{_MJPEG_BOUNDARY}--\r\n".encode()
            finally:
                cap.release()
                try:
                    os.unlink(tmp.name)
                except OSError:
                    pass

        return StreamingResponse(
            _UnlinkOnClose(produce(), tmp.name),
            content_type=f"multipart/x-mixed-replace; boundary={_MJPEG_BOUNDARY}",
            headers=[("Cache-Control", "no-cache")])

    @app.get("/api/detect/sample/{filename}")
    def detect_sample(req: Request) -> Response:
        import cv2

        filename = os.path.basename(req.path_params["filename"])
        fpath = SAMPLES_DIR / filename
        if not fpath.exists() or not fpath.is_file():
            raise HTTPError(404, f"Sample '{filename}' not found.")
        img = cv2.imread(str(fpath))
        if img is None:
            raise HTTPError(500, "Could not read sample image.")
        return JSONResponse(_run_detection(img))

    @app.get("/api/health")
    def health(req: Request) -> Response:
        # backend: the device type of the served detector, else the card
        # that the first request builds it on
        detector = _singleton.loaded()
        backend = detector.device.type if detector is not None else "cuda"
        devices = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
        return JSONResponse({"status": "ok", "backend": backend, "devices": devices})

    return app


app = create_app()


def serve(argv: list[str] | None = None) -> None:
    """Launch the RTMODT web application on the port (``--host``, ``--port``,
    ``--reload``, the reference's flags)."""
    import argparse

    from rtmodt_tpu_torch.serving.wsgi import run_server

    ap = argparse.ArgumentParser(description="Launch the RTMODT web application.")
    ap.add_argument("--host", default="0.0.0.0", help="Bind host.")
    ap.add_argument("--port", default=8000, type=int, help="Port.")
    ap.add_argument("--reload", dest="do_reload", action="store_true",
                    help="(accepted for CLI parity; hot reload not supported)")
    args = ap.parse_args(argv)
    if args.do_reload:
        logger.warning("--reload is a no-op in the stdlib server")
    logger.info(f"Starting RTMODT Web UI (PyTorch port) on http://{args.host}:{args.port}")
    run_server(app, args.host, args.port)


if __name__ == "__main__":
    serve()
