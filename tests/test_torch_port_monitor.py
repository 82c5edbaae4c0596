"""The port's MJPEG live monitor (``rtmodt_tpu_torch/serving/monitor.py``)
and ``visualization.mjpeg_port`` / ``--mjpeg-port`` on the CPU.

The cases of ``tests/test_monitor.py`` on the port's ``LiveMonitor``;
``mjpeg_port`` validated as the reference's loader validates it, value for
value; ``Pipeline.run`` and ``MultiStreamPipeline.run`` with a monitor (every
annotated frame or mosaic published, the monitor closed at the end); the
CLI's ``--mjpeg-port`` for one stream and for the mosaic.  The pipelines run
random yolov8n weights at 128 px: the monitor's wiring is under test, not
the detections.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import rtmodt_tpu_torch.serving.monitor as monitor_mod
from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.serving.monitor import LiveMonitor
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

H, W, N_FRAMES = 96, 160, 6


@pytest.fixture()
def monitor():
    m = LiveMonitor(port=0, host="127.0.0.1", max_fps=1000.0)
    yield m
    m.close()


def _frame(val: int) -> np.ndarray:
    f = np.full((48, 64, 3), val, np.uint8)
    f[:8, :8] = 255 - val            # corner marker: frames differ
    return f


def _decode(jpg: bytes) -> np.ndarray:
    import cv2

    return cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)


def test_single_frame_endpoint(monitor):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{monitor.port}/frame", timeout=5)
    assert e.value.code == 404
    monitor.publish(_frame(3))        # a poll-only client gets the latest frame
    with urllib.request.urlopen(f"http://127.0.0.1:{monitor.port}/frame", timeout=5) as r:
        body = r.read()
        assert r.headers["Content-Type"] == "image/jpeg"
    assert _decode(body).shape == (48, 64, 3)


def test_index_page(monitor):
    with urllib.request.urlopen(f"http://127.0.0.1:{monitor.port}/", timeout=5) as r:
        assert "/stream" in r.read().decode()


def test_stream_yields_distinct_frames(monitor):
    stop = threading.Event()

    def publish_until():
        i = 0
        while not stop.is_set():
            monitor.publish(_frame(i % 200))
            i += 1
            time.sleep(0.005)

    pub = threading.Thread(target=publish_until, daemon=True)
    pub.start()
    try:
        req = urllib.request.urlopen(f"http://127.0.0.1:{monitor.port}/stream", timeout=10)
        assert req.status == 200
        assert req.headers["Content-Type"].startswith("multipart/x-mixed-replace")
        buf = b""
        deadline = time.monotonic() + 10.0
        while buf.count(b"\xff\xd8\xff") < 2:
            assert time.monotonic() < deadline, "stream produced <2 frames"
            chunk = req.read1(65536)
            assert chunk, "stream ended early"
            buf += chunk
        req.close()
    finally:
        stop.set()
        pub.join(timeout=5)
    assert not pub.is_alive()
    parts = [p for p in buf.split(b"--rtmodtlive") if b"image/jpeg" in p]
    imgs = []
    for p in parts[:2]:
        head, body = p.split(b"\r\n\r\n", 1)
        n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
        img = _decode(body[:n])
        assert img is not None and img.shape == (48, 64, 3)
        imgs.append(img)
    assert not np.array_equal(imgs[0], imgs[1])     # latest-wins buffer


def test_publish_without_viewers_stores_latest_only(monitor):
    for i in range(10):
        monitor.publish(_frame(i))
    assert monitor._seq == 10
    assert monitor._frame is not None and monitor._jpeg is None


def test_close_unblocks_viewer(monitor):
    req = urllib.request.urlopen(f"http://127.0.0.1:{monitor.port}/stream", timeout=10)
    t0 = time.monotonic()
    threading.Timer(0.3, monitor.close).start()
    data = req.read()              # must not hang: close ends the stream
    assert time.monotonic() - t0 < 8.0
    assert data.endswith(b"--rtmodtlive--\r\n")


@pytest.mark.parametrize("value", [None, 0, 1, 8080, 65535, True, -1, 65536, 70000,
                                   "8080", 80.0, [8080]])
def test_mjpeg_port_validated_as_the_reference(value):
    over = {"visualization": {"mjpeg_port": value}}
    try:
        want = jax_load_config(overrides=over).visualization.mjpeg_port
    except ValueError as e:
        assert "mjpeg_port" in str(e)
        with pytest.raises(ValueError, match="visualization.mjpeg_port"):
            load_config(overrides=over)
    else:
        assert load_config(overrides=over).visualization.mjpeg_port == want


# -- the pipelines with a monitor ------------------------------------------------


@pytest.fixture()
def monitors(monkeypatch):
    """Every LiveMonitor the pipelines open, real ones on port 0."""
    opened: list[LiveMonitor] = []

    class Recorded(LiveMonitor):
        def __init__(self, port, host="127.0.0.1", **kw):
            assert port == 0
            super().__init__(port, host, **kw)
            self.published: list[np.ndarray] = []
            opened.append(self)

        def publish(self, frame_bgr):
            self.published.append(frame_bgr.copy())
            super().publish(frame_bgr)

    monkeypatch.setattr(monitor_mod, "LiveMonitor", Recorded)
    return opened


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    paths = []
    for i in range(2):
        paths.append(str(d / f"cam{i}.mp4"))
        write_synthetic_video(paths[-1], frames=N_FRAMES, h=H, w=W, n_objects=2, fps=25.0,
                              seed=i)
    return paths


def _overrides(tmp_path, **extra) -> dict:
    base = {"system": {"device": "cpu", "log_dir": str(tmp_path / "logs")},
            "detection": {"model": "yolov8n", "input_size": 128, "half": False},
            "events": {"enabled": False},
            "profiling": {"warmup_frames": 0, "log_interval": 0},
            "visualization": {"enabled": False, "mjpeg_port": 0}}
    for k, v in extra.items():
        base[k] = {**base.get(k, {}), **v}
    return base


def _assert_served_and_closed(m: LiveMonitor, n: int, shape: tuple) -> None:
    assert m._seq == n and m._frame.shape == shape
    assert m._closed and not m._thread.is_alive()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{m.port}/frame", timeout=2)


@pytest.mark.parametrize("per_stage,depth", [(True, 0), (False, 2)])
def test_pipeline_run_publishes_every_annotated_frame(clips, tmp_path, monitors,
                                                      per_stage, depth):
    import cv2

    from rtmodt_tpu_torch.runtime.pipeline import Pipeline

    cfg = load_config(overrides=_overrides(
        tmp_path, profiling={"per_stage": per_stage},
        parallel={"chunk_size": 4, "pipeline_depth": depth}))
    pipe = Pipeline(cfg)
    assert pipe.renderer is not None            # mjpeg_port implies the renderer
    pipe.run(clips[0])                          # per frame: the renderer forbids chunks
    assert len(monitors) == 1 and pipe.profiler.frame_count == N_FRAMES
    _assert_served_and_closed(monitors[0], N_FRAMES, (H, W, 3))
    cap = cv2.VideoCapture(clips[0])
    raw = cap.read()[1]
    cap.release()
    assert not np.array_equal(monitors[0].published[0], raw)    # annotated


def test_multistream_run_publishes_the_mosaic(clips, tmp_path, monitors):
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline

    cfg = load_config(overrides=_overrides(
        tmp_path, visualization={"enabled": True},
        parallel={"num_streams": 2, "chunk_size": 2, "pipeline_depth": 1}))
    summary = MultiStreamPipeline(cfg).run(clips)
    assert summary["per_stream_frames"] == [N_FRAMES, N_FRAMES]
    assert len(monitors) == 1
    _assert_served_and_closed(monitors[0], N_FRAMES, (H, 2 * W, 3))


@pytest.mark.parametrize("n_sources", [1, 2])
def test_cli_mjpeg_port(clips, tmp_path, monitors, n_sources):
    from tools.run_pipeline_torch import main

    cfg = tmp_path / "cfg.yaml"
    over = _overrides(tmp_path)
    del over["visualization"]                     # the flag alone asks for the monitor
    cfg.write_text(json.dumps(over))
    args = ["-c", str(cfg), "--mjpeg-port", "0", "--max-frames", "4"]
    for path in clips[:n_sources]:
        args += ["-s", path]
    assert main(args) == 0
    assert len(monitors) == 1
    _assert_served_and_closed(monitors[0], 4, (H, n_sources * W, 3))
