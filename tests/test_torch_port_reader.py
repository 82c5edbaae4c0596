"""The port's ``RTSPReader`` against the reference package's.

A 25-fps clip written by ``write_synthetic_video`` is read by both readers:
frame ids, stream timestamps and frame bytes must be identical (exact), and
lossless file mode must see every frame.  Reconnect, give-up and
open-failure are driven by a scripted fake capture, as
``tests/test_ingestion_recovery.py`` drives the reference's.  Every wait is
bounded: ``read_new`` timeouts, deadlines on the loops, joins in ``stop``.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from rtmodt_tpu.ingestion.rtsp_reader import RTSPReader as JaxReader
from rtmodt_tpu.utils.synthetic import write_synthetic_video as jax_write_video
from rtmodt_tpu_torch.ingestion.rtsp_reader import RTSPReader
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

N_FRAMES, H, W, FPS = 14, 96, 160, 25.0


def _read_all(reader_cls, path, **kw):
    out = []
    with reader_cls(path, **kw) as r:
        last = 0
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            frame, fid, ts = r.read_new(last, timeout=2.0)
            if frame is None:
                if r.is_eof:
                    break
                continue
            last = fid
            out.append((fid, ts, frame))
        fps = r.fps
    return out, fps


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip25.mp4")
    write_synthetic_video(path, frames=N_FRAMES, h=H, w=W, n_objects=3, fps=FPS, seed=2)
    return path


def test_synthetic_video_file_is_byte_identical_to_the_reference(clip, tmp_path):
    ref = str(tmp_path / "ref.mp4")
    jax_write_video(ref, frames=N_FRAMES, h=H, w=W, n_objects=3, fps=FPS, seed=2)
    with open(clip, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_file_ids_timestamps_and_bytes_match_the_reference_reader(clip):
    got, fps = _read_all(RTSPReader, clip)
    want, want_fps = _read_all(JaxReader, clip)
    assert fps == want_fps == FPS
    assert len(got) == len(want) == N_FRAMES       # lossless: every frame, once
    for (gid, gts, gf), (wid, wts, wf) in zip(got, want):
        assert (gid, gts) == (wid, wts)
        np.testing.assert_array_equal(gf, wf)
    assert [g[0] for g in got] == list(range(1, N_FRAMES + 1))
    assert [g[1] for g in got] == [i / FPS for i in range(N_FRAMES)]


def test_read_returns_the_latest_frame_and_consumes_it(clip):
    with RTSPReader(clip) as r:
        deadline = time.monotonic() + 10.0
        frame, fid, ts = r.read()
        while frame is None and time.monotonic() < deadline:
            time.sleep(0.01)
            frame, fid, ts = r.read()
        assert frame is not None and fid == 1 and ts == 0.0
        frame2, fid2, _ = r.read_new(fid, timeout=5.0)
        assert frame2 is not None and fid2 == 2


def test_live_sources_default_to_newest_frame_mode():
    assert RTSPReader("rtsp://cam/1").realtime and RTSPReader(0).realtime
    assert not RTSPReader("clip.mp4").realtime


class FakeCapture:
    """Scripted cv2.VideoCapture double (as in test_ingestion_recovery.py):
    3 good frames, then the stream dies; ``opens`` scripts each open."""

    script = {"opens": [], "instances": 0}

    def __init__(self, source, *a):
        FakeCapture.script["instances"] += 1
        self._open = FakeCapture.script["opens"].pop(0) if FakeCapture.script["opens"] else True
        self._grabs = 0

    def isOpened(self):
        return self._open

    def set(self, *a):
        return True

    def get(self, prop):
        return 30.0

    def grab(self):
        self._grabs += 1
        return self._grabs <= 3

    def retrieve(self):
        return True, np.zeros((48, 64, 3), np.uint8)

    def release(self):
        self._open = False


@pytest.fixture()
def fake_cv2(monkeypatch):
    import cv2

    FakeCapture.script = {"opens": [], "instances": 0}
    monkeypatch.setattr(cv2, "VideoCapture", FakeCapture)
    return FakeCapture


def test_reconnects_after_stream_loss(fake_cv2):
    fake_cv2.script["opens"] = [True, True, True]
    r = RTSPReader("rtsp://cam/1", reconnect_delay_sec=0.01, max_reconnects=5)
    with r:
        deadline = time.time() + 5.0
        seen = last = 0
        while time.time() < deadline and seen < 5:
            frame, fid, ts = r.read_new(last, timeout=0.5)
            if frame is not None:
                last = fid
                seen += 1
    assert seen >= 4                      # more than the 3 frames of one open
    assert fake_cv2.script["instances"] >= 2


def test_gives_up_after_max_reconnects(fake_cv2):
    fake_cv2.script["opens"] = [True] + [False] * 20
    r = RTSPReader("rtsp://cam/1", reconnect_delay_sec=0.01, max_reconnects=2)
    with r:
        deadline = time.time() + 5.0
        while not r.is_eof and time.time() < deadline:
            time.sleep(0.05)
    assert r.is_eof
    assert fake_cv2.script["instances"] == 3      # the first open + 2 reconnects


def test_backoff_is_interruptible_by_stop(fake_cv2):
    fake_cv2.script["opens"] = [True] + [False] * 20
    r = RTSPReader("rtsp://cam/1", reconnect_delay_sec=30.0, max_reconnects=5)
    r.start()
    thread = r._thread
    time.sleep(0.2)                       # the stream dies, a 30 s backoff starts
    t0 = time.monotonic()
    r.stop()
    thread.join(timeout=2.0)
    assert not thread.is_alive() and time.monotonic() - t0 < 2.0
    assert fake_cv2.script["instances"] == 1      # no capture opened after stop


def test_open_failure_raises_immediately(fake_cv2):
    fake_cv2.script["opens"] = [False]
    with pytest.raises(ConnectionError):
        RTSPReader("rtsp://cam/1").start()
