"""The port's web app (``rtmodt_tpu_torch/serving/server.py``) on the CPU.

Two parts.  The contract: the cases of ``tests/test_web_api.py`` against the
port's app, with a fake detector that returns the port's ``Detections`` on
the CPU (routes, 400/404/405/413, CORS preflight, the multipart parser,
sessions, algorithm selection, zone validation, MJPEG framing, a real
socket), plus the port's own rules: trackers on the served detector's
device, the video route's tracker cache keyed by (algorithm, device), and
no autograd state from a fresh request thread.

The parity: the JAX app (a ``rtmodt_tpu`` ``Detector`` injected through its
``set``) and the port's app (a CPU ``Detector`` injected through its
``set``) serve the trained rich640d weights at 256 px in float32, conf 0.35,
and answer the same requests.  Ints, strings, ids, trails and event kinds
must be equal; boxes within 1e-4 px and scores within 1e-5 (the tolerances
of ``tests/test_torch_port_detector.py``: the DFL softmax rounds an ulp
differently in XLA and PyTorch).  ``inference_ms``, ``processing_fps`` and
wall-clock event fields (``timestamp_utc``, and a live session's wall-clock
``dwell_time_sec``) are left out.
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

import rtmodt_tpu.serving.server as jax_srv
import rtmodt_tpu_torch.serving.server as srv
from rtmodt_tpu.config.loader import DetectionConfig as JaxDetectionConfig
from rtmodt_tpu.detection.detector import Detector as JaxDetector
from rtmodt_tpu.serving.wsgi import TestClient as JaxTestClient
from rtmodt_tpu_torch.config.loader import DetectionConfig
from rtmodt_tpu_torch.detection.detector import Detections, Detector
from rtmodt_tpu_torch.serving.wsgi import Request
from rtmodt_tpu_torch.serving.wsgi import TestClient as Client
from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame, write_synthetic_video

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "checkpoints", "rich640d", "ema_final.npz")
BOX_ATOL = 1e-4
SCORE_ATOL = 1e-5
H, W = 288, 512          # every parity request uses this frame size


def _jpeg_bytes(w=100, h=100, color=0):
    import cv2

    img = np.full((h, w, 3), color, np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


class FakeDetector:
    """Deterministic detector double on the CPU: one fixed box per image."""

    class_names = ["person", "bicycle", "car"]
    device = torch.device("cpu")

    def detect(self, img):
        h, w = img.shape[:2]
        return Detections(
            np.array([[w * 0.1, h * 0.1, w * 0.5, h * 0.6]], np.float32),
            np.array([0.87], np.float32),
            np.array([0], np.int32),
            self.class_names,
        )


@pytest.fixture()
def client(tmp_path, monkeypatch):
    web_dir = tmp_path / "web"
    (web_dir / "static" / "samples").mkdir(parents=True)
    (web_dir / "index.html").write_text("<html><body>RTMODT-TPU demo</body></html>")
    (web_dir / "static" / "app.js").write_text("// app")
    monkeypatch.setattr(srv, "WEB_DIR", web_dir)
    monkeypatch.setattr(srv, "STATIC_DIR", web_dir / "static")
    monkeypatch.setattr(srv, "SAMPLES_DIR", web_dir / "static" / "samples")
    monkeypatch.chdir(tmp_path)          # the zone engines write logs/web_events.jsonl
    srv._singleton.set(FakeDetector())
    return Client(srv.create_app())


def _mp4_bytes(tmp_path, frames=8, size=96):
    p = tmp_path / "clip.mp4"
    write_synthetic_video(str(p), frames=frames, h=size, w=size, n_objects=1)
    return p.read_bytes()


# -- the contract -------------------------------------------------------------


def test_serves_over_tcp(client):
    import urllib.request
    from wsgiref.simple_server import make_server

    from rtmodt_tpu_torch.serving.wsgi import _QuietHandler, _ThreadingWSGIServer

    httpd = make_server("127.0.0.1", 0, srv.create_app(),
                        server_class=_ThreadingWSGIServer, handler_class=_QuietHandler)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/samples", timeout=5) as r:
            assert r.status == 200
            assert json.loads(r.read()) == {"samples": []}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5) as r:
            assert "RTMODT" in r.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)
    assert not t.is_alive()


@pytest.mark.parametrize("path,status,body", [
    ("/", 200, "RTMODT"),
    ("/static/app.js", 200, "app"),
    ("/static/nope.js", 404, None),
    ("/static/samples/ghost.jpg", 404, None),
    ("/api/nope", 404, None),
    ("/api/detect/sample/ghost.jpg", 404, None),
])
def test_static_routes(client, path, status, body):
    r = client.get(path)
    assert r.status_code == status
    if body is not None:
        assert body in r.text


def test_health_names_the_served_device(client):
    r = client.get("/api/health")
    assert r.status_code == 200
    data = r.json()
    assert set(data) == {"status", "backend", "devices"}
    assert data["status"] == "ok" and data["backend"] == "cpu"
    assert data["devices"] == [torch.cuda.get_device_name(i)
                               for i in range(torch.cuda.device_count())]


def test_samples_list(client):
    assert client.get("/api/samples").json() == {"samples": []}
    (srv.SAMPLES_DIR / "street_scene.jpg").write_bytes(_jpeg_bytes(120, 80))
    (srv.SAMPLES_DIR / "notes.txt").write_text("not an image")
    assert client.get("/api/samples").json()["samples"] == [{
        "name": "Street Scene", "filename": "street_scene.jpg",
        "url": "/static/samples/street_scene.jpg"}]
    r = client.get("/api/detect/sample/street_scene.jpg")
    assert r.status_code == 200
    _check_schema(r.json())
    assert r.json()["image_size"] == [120, 80]


def _check_schema(data):
    assert set(data) == {"detections", "tracks", "inference_ms", "num_objects",
                         "image_size"}
    assert data["tracks"] == []
    assert data["num_objects"] == len(data["detections"])
    for d in data["detections"]:
        assert set(d) == {"bbox", "confidence", "class_id", "class_name"}
        assert len(d["bbox"]) == 4


def test_upload_image(client):
    r = client.post("/api/detect/image", files={"file": ("t.jpg", _jpeg_bytes(), "image/jpeg")})
    assert r.status_code == 200
    data = r.json()
    _check_schema(data)
    assert data["image_size"] == [100, 100]
    assert data["detections"][0]["class_name"] == "person"


def test_frame_base64_with_data_url_prefix(client):
    r = client.post("/api/detect/frame", json_body={
        "image": "data:image/jpeg;base64," + _b64(_jpeg_bytes(64, 48))})
    assert r.status_code == 200
    _check_schema(r.json())
    assert r.json()["image_size"] == [64, 48]


@pytest.mark.parametrize("method,path,kwargs,status", [
    ("post", "/api/detect/image", {"files": {"file": ("t.jpg", b"not an image", "image/jpeg")}}, 400),
    ("post", "/api/detect/image", {"files": {"other": ("t.jpg", b"x", "image/jpeg")}}, 400),
    ("post", "/api/detect/frame", {"json_body": {"image": "!!!notb64!!!"}}, 400),
    ("post", "/api/detect/frame", {"json_body": {"image": _b64(b"not an image")}}, 400),
    ("post", "/api/samples", {}, 405),
    ("get", "/api/detect/image", {}, 405),
    ("post", "/api/track/video", {"files": {"file": ("x.mp4", b"not a video", "video/mp4")}}, 400),
    ("post", "/api/track/video", {"json_body": {"nope": 1}}, 400),
    ("post", "/api/stream/video", {"files": {"file": ("x.mp4", b"not a video", "video/mp4")}}, 400),
    ("post", "/api/stream/video", {}, 400),
    ("get", "/api/stream/demo?algorithm=nope", {}, 400),
    ("get", "/api/stream/demo?fps=abc", {}, 400),
    ("get", "/api/stream/demo?seconds=nan", {}, 400),
    ("get", "/api/stream/demo?seconds=inf", {}, 400),
    ("get", "/api/stream/demo?objects=-inf", {}, 400),
])
def test_bad_requests(client, method, path, kwargs, status):
    assert getattr(client, method)(path, **kwargs).status_code == status


def test_frame_bad_json_400(client):
    r = client._call("POST", "/api/detect/frame", b"{invalid", "application/json")
    assert r.status_code == 400


@pytest.mark.parametrize("route", ["/api/track/video", "/api/stream/video"])
def test_video_over_64_mb_is_413(client, route):
    big = b"\0" * (64 * 1024 * 1024 + 1)
    assert client.post(route, files={"file": ("big.mp4", big, "video/mp4")}).status_code == 413


def test_cors_preflight_options(client):
    r = client._call("OPTIONS", "/api/detect/frame")
    assert r.status_code == 204
    assert "POST" in r.headers.get("Access-Control-Allow-Methods", "")
    assert client._call("OPTIONS", "/api/nope").status_code == 404


@pytest.mark.parametrize("body,want", [
    # payload bytes ending in CR/LF must survive byte-exact
    (b"--B\r\nContent-Disposition: form-data; name=\"file\"; filename=\"x.bin\"\r\n"
     b"Content-Type: application/octet-stream\r\n\r\n\x00\x01binary\r\n\r\n\n\r\n\r\n--B--\r\n",
     {"file": ("x.bin", b"\x00\x01binary\r\n\r\n\n\r\n")}),
    # filename= before name=: the key is still the name parameter
    (b"--B\r\nContent-Disposition: form-data; filename=\"a.mp4\"; name=\"file\"\r\n"
     b"\r\ncontent\r\n--B--\r\n", {"file": ("a.mp4", b"content")}),
])
def test_multipart_parser(body, want):
    req = Request({"REQUEST_METHOD": "POST", "PATH_INFO": "/x",
                   "CONTENT_TYPE": "multipart/form-data; boundary=B",
                   "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)})
    assert req.files() == want


def test_session_tracking_populates_tracks(client):
    payload = {"image": _b64(_jpeg_bytes()), "session_id": "test-sess-1"}
    ids = []
    for _ in range(3):
        data = client.post("/api/detect/frame", json_body=payload).json()
        assert len(data["tracks"]) == 1
        t = data["tracks"][0]
        assert set(t) == {"track_id", "bbox", "confidence", "class_id", "class_name",
                          "age", "trail"}
        ids.append(t["track_id"])
    assert len(set(ids)) == 1 and data["tracks"][0]["age"] == 3
    assert len(data["tracks"][0]["trail"]) == 3
    payload = {"image": _b64(_jpeg_bytes())}
    assert client.post("/api/detect/frame", json_body=payload).json()["tracks"] == []


def test_session_algorithm_selection_and_omission(client):
    img = _b64(_jpeg_bytes())
    payload = {"image": img, "session_id": "algo-sess", "algorithm": "ocsort"}
    ages = []
    for _ in range(3):
        tracks = client.post("/api/detect/frame", json_body=payload).json()["tracks"]
        ages += [t["age"] for t in tracks]
    assert ages and ages[-1] >= 2
    # omitting the field keeps the ocsort session
    r = client.post("/api/detect/frame", json_body={"image": img, "session_id": "algo-sess"})
    assert r.json()["tracks"][0]["age"] == 4
    # switching restarts it: age resets
    r = client.post("/api/detect/frame", json_body={**payload, "algorithm": "bytetrack"})
    assert r.json()["tracks"][0]["age"] == 1
    r = client.post("/api/detect/frame", json_body={**payload, "algorithm": "sortx"})
    assert r.status_code == 400


def test_session_zones_fire_live_alerts(client):
    img = _b64(_jpeg_bytes())
    zones = [{"name": "gate", "polygon": [[0, 0], [100, 0], [100, 100], [0, 100]],
              "cooldown_sec": 3600}]
    payload = {"image": img, "session_id": "zone-sess", "zones": zones}
    data = client.post("/api/detect/frame", json_body=payload).json()
    assert data["zones"] == [{"name": "gate",
                              "polygon": [[0, 0], [100, 0], [100, 100], [0, 100]]}]
    assert [e["event_type"] for e in data["events"]] == ["intrusion"]
    assert client.post("/api/detect/frame", json_body=payload).json()["events"] == []
    data = client.post("/api/detect/frame",
                       json_body={"image": img, "session_id": "zone-sess"}).json()
    assert "events" not in data and "zones" not in data
    assert len(data["tracks"]) == 1


@pytest.mark.parametrize("zones,session", [
    ([{"polygon": [[0, 0], [100, 0], [100, 100]]}], None),     # zones without session
    ([{"polygon": [[0, 0]]}], "s"),
    ([{"polygon": [[0, 0], [9, 0], [9, 9]], "dwell_time_sec": None}], "s"),
    ([{"polygon": [[0, 0], [9, 0], [9, 9]], "dwell_time_sec": "abc"}], "s"),
    ([{"polygon": [[0, 0], [9, 0], [9, 9]], "cooldown_sec": float("nan")}], "s"),
    ([{"polygon": [[float("inf"), 0], [9, 0], [9, 9]]}], "s"),
    ([{"polygon": [[0, 0], [9, 0], [9, 9]], "classes": ["car"]}], "s"),
    ([], "s"),
])
def test_session_zone_validation(client, zones, session):
    payload = {"image": _b64(_jpeg_bytes()), "zones": zones}
    if session:
        payload["session_id"] = session
    assert client.post("/api/detect/frame", json_body=payload).status_code == 400


def test_invalid_zones_do_not_clobber_live_engine(client):
    img = _b64(_jpeg_bytes())
    zones = [{"name": "gate", "polygon": [[0, 0], [100, 0], [100, 100], [0, 100]],
              "cooldown_sec": 3600}]
    sid = "clobber-sess"
    r = client.post("/api/detect/frame", json_body={"image": img, "session_id": sid,
                                                    "zones": zones})
    assert len(r.json()["events"]) == 1
    bad = {"image": img, "session_id": sid, "zones": [{"polygon": [[0, 0]]}]}
    assert client.post("/api/detect/frame", json_body=bad).status_code == 400
    assert client.post("/api/detect/frame", json_body=bad).status_code == 400
    r = client.post("/api/detect/frame", json_body={"image": img, "session_id": sid,
                                                    "zones": zones})
    assert r.status_code == 200 and r.json()["events"] == []


@pytest.mark.parametrize("algorithm", ["bytetrack", "botsort"])
def test_track_video_persistent_ids(client, tmp_path, algorithm):
    r = client.post(f"/api/track/video?algorithm={algorithm}",
                    files={"file": ("clip.mp4", _mp4_bytes(tmp_path), "video/mp4")})
    assert r.status_code == 200
    data = r.json()
    assert data["num_frames"] == 8 and data["num_tracks"] == 1
    assert len({t["track_id"] for f in data["frames"] for t in f["tracks"]}) == 1
    assert data["frames"][0]["frame_id"] == 1
    assert data["image_size"] == [96, 96] and data["processing_fps"] > 0
    assert client.post("/api/track/video?algorithm=nope", files={
        "file": ("clip.mp4", b"x", "video/mp4")}).status_code == 400


def test_track_video_stride_and_cap(client, tmp_path):
    content = _mp4_bytes(tmp_path, frames=10)
    r = client.post("/api/track/video?max_frames=3&stride=2",
                    files={"file": ("clip.mp4", content, "video/mp4")})
    assert [f["frame_id"] for f in r.json()["frames"]] == [1, 3, 5]
    r = client.post("/api/track/video?max_frames=0",
                    files={"file": ("clip.mp4", content, "video/mp4")})
    assert r.status_code == 200 and r.json()["num_frames"] == 1
    r = client.post("/api/track/video?stride=x",
                    files={"file": ("clip.mp4", content, "video/mp4")})
    assert r.status_code == 400


@pytest.mark.parametrize("polygon,n_events", [
    ([[0, 0], [96, 0], [96, 96], [0, 96]], 1),
    ([[80, 80], [95, 80], [95, 95], [80, 95]], 0),
])
def test_track_video_with_zones(client, tmp_path, polygon, n_events):
    zones = [{"name": "lobby", "polygon": polygon}]
    r = client.post("/api/track/video", files={
        "file": ("clip.mp4", _mp4_bytes(tmp_path), "video/mp4"),
        "zones": ("", json.dumps(zones).encode(), "")})
    assert r.status_code == 200
    data = r.json()
    assert data["zones"] == [{"name": "lobby", "polygon": polygon}]
    assert len(data["events"]) == n_events
    if n_events:
        ev = data["events"][0]
        assert set(ev) == {"timestamp_utc", "event_type", "zone_name", "track_id",
                           "class_id", "class_name", "dwell_time_sec", "bbox_xyxy",
                           "centroid", "frame_id", "metadata"}
        assert (ev["zone_name"], ev["event_type"], ev["track_id"]) == ("lobby", "intrusion", 1)
        assert data["zone_counts"] == {"lobby": {"entries": 1, "unique_tracks": 1,
                                                 "current": 1}}


@pytest.mark.parametrize("payload", [
    b"not json",
    json.dumps([]).encode(),
    json.dumps([{"polygon": [[0, 0], [1, 1]]}]).encode(),
    json.dumps([{"polygon": "nope"}]).encode(),
    json.dumps([{"polygon": [[0, 0], [9, 0], [9, 9]], "trigger": "teleport"}]).encode(),
    json.dumps([{"polygon": [[0, 0], [9, 0], [9, 9]]}] * 9).encode(),
    json.dumps([{"name": "gate", "polygon": [[0, 0], [9, 0], [9, 9]]},
                {"name": "gate", "polygon": [[20, 20], [29, 20], [29, 29]]}]).encode(),
])
def test_track_video_zones_validation_400(client, payload):
    r = client.post("/api/track/video", files={"file": ("clip.mp4", b"x", "video/mp4"),
                                               "zones": ("", payload, "")})
    assert r.status_code == 400


def _mjpeg_parts(content: bytes) -> list[bytes]:
    boundary = b"--rtmodtframe"
    assert content.endswith(boundary + b"--\r\n")
    payloads = []
    for piece in content.split(boundary)[1:]:
        if piece.startswith(b"--"):
            continue
        head, body = piece.split(b"\r\n\r\n", 1)
        assert b"Content-Type: image/jpeg" in head
        n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
        payloads.append(body[:n])
        assert body[n:] == b"\r\n"
    return payloads


def _decode(jpg: bytes):
    import cv2

    return cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)


def test_stream_demo_parts(client):
    r = client.get("/api/stream/demo?seconds=0.1&fps=30&objects=3")
    assert r.status_code == 200
    assert r.headers["Content-Type"] == "multipart/x-mixed-replace; boundary=rtmodtframe"
    assert "Content-Length" not in r.headers
    parts = _mjpeg_parts(r.content)
    assert len(parts) == 3                       # int(0.1 s * 30 fps)
    assert all(_decode(p).shape == (480, 640, 3) for p in parts)


def test_stream_video_annotated(client, tmp_path):
    r = client.post("/api/stream/video?max_frames=5&stride=2",
                    files={"file": ("clip.mp4", _mp4_bytes(tmp_path), "video/mp4")})
    assert r.status_code == 200
    assert r.headers["Content-Type"].startswith("multipart/x-mixed-replace")
    parts = _mjpeg_parts(r.content)
    assert len(parts) == 4                       # frames 1, 3, 5, 7 of 8
    assert all(_decode(p).shape == (96, 96, 3) for p in parts)
    assert parts[0] != parts[1]


def test_trackers_take_the_served_detector_device(client, tmp_path):
    cpu = torch.device("cpu")
    client.post("/api/detect/frame", json_body={"image": _b64(_jpeg_bytes()),
                                                "session_id": "dev-sess"})
    sess = srv._sessions.get("dev-sess", None, cpu)
    assert sess.tracker.device == cpu and sess.tracker.state.boxes.device == cpu
    client.post("/api/track/video", files={"file": ("c.mp4", _mp4_bytes(tmp_path), "video/mp4")})
    assert ("bytetrack", cpu) in srv._video_trackers._trackers
    assert all(isinstance(k, tuple) and len(k) == 2 for k in srv._video_trackers._trackers)
    lock, tracker = srv._video_trackers.acquire("bytetrack", cpu)
    assert tracker.device == cpu
    assert srv._video_trackers.acquire("bytetrack", cpu)[1] is tracker


@pytest.mark.parametrize("algorithm", ["deepsort", "botsort"])
def test_fresh_request_thread_leaves_no_autograd_state(client, algorithm):
    """Grad mode is per thread and on by default in a new one: a request
    thread's tracker and embedder work must leave no autograd graph."""
    sid = f"grad-{algorithm}"
    out = {}

    def request():
        for _ in range(4):          # deepsort confirms a track at its third hit
            out["r"] = client.post("/api/detect/frame", json_body={
                "image": _b64(_jpeg_bytes()), "session_id": sid, "algorithm": algorithm})
        out["grad"] = torch.is_grad_enabled()

    t = threading.Thread(target=request)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and out["grad"]
    assert out["r"].status_code == 200 and len(out["r"].json()["tracks"]) == 1
    st = srv._sessions.get(sid, None, torch.device("cpu")).tracker.state
    for x in st:
        if isinstance(x, torch.Tensor):
            assert not x.requires_grad and x.grad_fn is None


def test_device_work_runs_on_one_long_lived_thread(client, tmp_path, monkeypatch):
    """Request threads are new for every request; the detector and the
    trackers run on the one device thread (cuDNN plans per thread)."""
    from rtmodt_tpu_torch.tracking.tracker import MultiObjectTracker

    names = []

    def recorded(inner):
        def fn(*args, **kw):
            names.append(threading.current_thread().name)
            return inner(*args, **kw)
        return fn

    monkeypatch.setattr(FakeDetector, "detect", recorded(FakeDetector.detect))
    monkeypatch.setattr(MultiObjectTracker, "update", recorded(MultiObjectTracker.update))

    def request(i):
        client.post("/api/detect/frame", json_body={"image": _b64(_jpeg_bytes()),
                                                    "session_id": f"thread-{i}"})
    threads = [threading.Thread(target=request, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    client.post("/api/track/video", files={"file": ("c.mp4", _mp4_bytes(tmp_path), "video/mp4")})
    assert len(names) == 2 * (4 + 8)
    assert len(set(names)) == 1 and names[0].startswith("rtmodt-device")


def test_serve_cli_parses_the_reference_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr("rtmodt_tpu_torch.serving.wsgi.run_server",
                        lambda app, host, port: seen.update(app=app, host=host, port=port))
    srv.serve(["--host", "127.0.0.1", "--port", "8123", "--reload"])
    assert seen == {"app": srv.app, "host": "127.0.0.1", "port": 8123}


def test_default_build_refuses_an_8_class_checkpoint(monkeypatch):
    """rich640d is an 8-class head: the default 80-class build fails on the
    weight tree, as the reference's does, rather than building another head."""
    monkeypatch.setenv("RTMODT_WEIGHTS", WEIGHTS)
    single = srv._DetectorSingleton()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="shape mismatch"):
        single.get()
    assert single.loaded() is None


# -- parity with the JAX app ---------------------------------------------------


@pytest.fixture(scope="module")
def apps():
    common = {"model": "yolov8s", "num_classes": 8, "input_size": 256, "weights": WEIGHTS,
              "half": False, "conf_threshold": 0.35, "iou_threshold": 0.45, "classes": None}
    port_det = Detector(DetectionConfig(**common), device="cpu", warmup=False)
    jax_det = JaxDetector(JaxDetectionConfig(**common), warmup=False)
    return port_det, jax_det


@pytest.fixture()
def clients(apps, tmp_path, monkeypatch):
    import cv2

    port_det, jax_det = apps
    samples = tmp_path / "samples"
    samples.mkdir()
    cv2.imwrite(str(samples / "scene.jpg"), moving_boxes_frame(9, H, W, 6, seed=2)[0])
    for mod in (srv, jax_srv):
        monkeypatch.setattr(mod, "SAMPLES_DIR", samples)
    monkeypatch.chdir(tmp_path)
    srv._singleton.set(port_det)
    jax_srv._singleton.set(jax_det)
    return Client(srv.create_app()), JaxTestClient(jax_srv.create_app())


_WALL = {"inference_ms", "processing_fps", "timestamp_utc"}


def _assert_same(got, want, key="", wall=_WALL):
    """Equal JSON, floats of boxes within BOX_ATOL and of scores within
    SCORE_ATOL; ``wall`` keys are left out."""
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            if k not in wall:
                _assert_same(got[k], want[k], k, wall)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (key, got, want)
        if key in ("bbox", "bbox_xyxy"):
            np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)
        else:
            for g, w in zip(got, want):
                _assert_same(g, w, key, wall)
    elif isinstance(want, float):
        assert isinstance(got, float), key
        assert abs(got - want) <= (SCORE_ATOL if key == "confidence" else 1e-9), (key, got, want)
    else:
        assert type(got) is type(want) and got == want, (key, got, want)


def _jpeg_of(t: int) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", moving_boxes_frame(t, H, W, 6, seed=2)[0])
    assert ok
    return buf.tobytes()


def test_parity_single_images(clients):
    port, ref = clients
    for get in (lambda c: c.get("/api/detect/sample/scene.jpg"),
                lambda c: c.post("/api/detect/image",
                                 files={"file": ("t.jpg", _jpeg_of(3), "image/jpeg")})):
        got, want = get(port), get(ref)
        assert got.status_code == want.status_code == 200
        assert want.json()["num_objects"] > 0
        _assert_same(got.json(), want.json())


def test_parity_webcam_session_with_zone(clients):
    port, ref = clients
    zones = [{"name": "left", "polygon": [[0, 0], [W // 2, 0], [W // 2, H], [0, H]],
              "cooldown_sec": 3600}]
    n_events = 0
    for t in range(6):
        payload = {"image": "data:image/jpeg;base64," + _b64(_jpeg_of(t)),
                   "session_id": "parity", "algorithm": "bytetrack", "zones": zones}
        got = port.post("/api/detect/frame", json_body=payload)
        want = ref.post("/api/detect/frame", json_body=payload)
        assert got.status_code == want.status_code == 200
        # a live session's dwell runs on the wall clock
        _assert_same(got.json(), want.json(), wall=_WALL | {"dwell_time_sec"})
        n_events += len(want.json()["events"])
    assert want.json()["tracks"] and n_events > 0


def test_parity_track_video_with_zones(clients, tmp_path):
    port, ref = clients
    clip = tmp_path / "clip.mp4"
    write_synthetic_video(str(clip), frames=12, h=H, w=W, n_objects=5, fps=25.0, seed=4)
    zones = json.dumps([
        {"name": "all", "polygon": [[0, 0], [W, 0], [W, H], [0, H]], "dwell_time_sec": 0.2},
        {"name": "top", "polygon": [[0, 0], [W, 0], [W, H // 2], [0, H // 2]]}]).encode()
    files = {"file": ("clip.mp4", clip.read_bytes(), "video/mp4"), "zones": ("", zones, "")}
    got = port.post("/api/track/video?algorithm=bytetrack", files=files)
    want = ref.post("/api/track/video?algorithm=bytetrack", files=files)
    assert got.status_code == want.status_code == 200
    assert want.json()["num_frames"] == 12 and want.json()["events"]
    _assert_same(got.json(), want.json())


def test_parity_stream_demo_part_count(clients):
    port, ref = clients
    got = port.get("/api/stream/demo?seconds=0.5&objects=3")
    want = ref.get("/api/stream/demo?seconds=0.5&objects=3")
    assert got.status_code == want.status_code == 200
    assert len(_mjpeg_parts(got.content)) == len(_mjpeg_parts(want.content)) == 5
