"""Kill-and-resume on the chunked path, the port against the JAX package.

One 25-fps clip (16 frames of 512x288, K = 4) goes through both packages'
``Pipeline.run_chunked`` with the trained rich640d weights at 256 px in
float32, zone events on.  The JAX chunk program runs the space-to-depth
front, which differs from ``planar_letterbox`` on a border ring
(``ops/planar_stem.py``); here its ``apply_front`` is replaced, for this
module only, by ``planar_letterbox`` and the forward, so that both packages
compute the same detections and only the pipelines and their snapshots are
compared.

Every resumed run (half the clip, a snapshot, a fresh pipeline that restores
it and goes on over the same file) must write the JAX uninterrupted run's
event log: identical less the wall-clock ``timestamp_utc``, ``bbox_xyxy``
within 1e-4 px; and its ``zone_counts``.  That holds for the port resumed
from its own snapshot, for the port resumed from a JAX snapshot, and for the
JAX package resumed from a port snapshot.  A clean-exit snapshot after a
padded final chunk (14 frames) holds the same tracker as the reference's.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtmodt_tpu.ops.s2d_front as jax_s2d_front
from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.events.zone_engine import ZoneEventEngine as JaxZoneEventEngine
from rtmodt_tpu.ops.yuv import content_dims as jax_content_dims
from rtmodt_tpu.ops.yuv import packed_meta as jax_packed_meta
from rtmodt_tpu.ops.yuv import planar_letterbox as jax_planar_letterbox
from rtmodt_tpu.runtime.pipeline import Pipeline as JaxPipeline
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

H, W, SIZE, K, N_FRAMES, HALF, FPS = 288, 512, 256, 4, 16, 8, 25.0
BOX_ATOL = 1e-4
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "rich640d", "ema_final.npz")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on one host, and models at this size gain little from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def overrides(log_path: str) -> dict:
    """Config shared by both packages' loaders (``transport: i420`` keeps the
    JAX chunk program on planes)."""
    return {
        "system": {"device": "cpu"},
        "detection": {"model": "yolov8s", "input_size": SIZE, "num_classes": 8,
                      "weights": WEIGHTS, "half": False},
        "events": {"zones": [
            {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
             "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2},
            {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
             "trigger": "crossing", "cooldown_sec": 1.0}],
            "alert": {"backend": "json_file", "log_path": log_path}},
        "profiling": {"per_stage": False, "warmup_frames": 0, "log_interval": 0},
        "parallel": {"chunk_size": K, "transport": "i420"},
        "visualization": {"enabled": False},
    }


@pytest.fixture(scope="module", autouse=True)
def planar_jax_front():
    geom = jax_packed_meta(H, W, SIZE)
    ch, cw = jax_content_dims(H, W, SIZE)
    t, le = geom.pad_top, geom.pad_left

    def apply_front(params, model, yp, up, vp, quant, dtype=jnp.bfloat16):
        y = yp[:, t:t + ch, le:le + cw]
        u = up[:, t // 2:(t + ch) // 2, le // 2:(le + cw) // 2]
        v = vp[:, t // 2:(t + ch) // 2, le // 2:(le + cw) // 2]
        img = jax.vmap(lambda a, b, c: jax_planar_letterbox(a, b, c, SIZE, le, t,
                                                            dtype=dtype))(y, u, v)
        return model.apply(params, img, train=False)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_s2d_front, "apply_front", apply_front)
        yield


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip25.mp4")
    write_synthetic_video(path, frames=N_FRAMES, h=H, w=W, n_objects=6, fps=FPS, seed=1)
    return path


def events(path: str) -> list[dict]:
    with open(path) as f:
        out = [json.loads(line) for line in f]
    for e in out:
        e.pop("timestamp_utc")
    return out


def assert_same_log(got_log: str, want_log: str) -> None:
    got, want = events(got_log), events(want_log)
    assert len(want) > 0 and len(got) == len(want)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want])
    assert got == want
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=BOX_ATOL)


def port(log: str) -> Pipeline:
    return Pipeline(load_config(overrides=overrides(log)))


_REFERENCE: list = []


def reference(log: str) -> JaxPipeline:
    """The JAX pipeline in the state of a fresh one: an empty tracker, no GMC
    history and a new zone engine writing to ``log``.  One instance serves
    the module, so that its chunk program compiles once."""
    cfg = jax_load_config(overrides=overrides(log))
    if not _REFERENCE:
        _REFERENCE.append(JaxPipeline(cfg))
    pipe = _REFERENCE[0]
    pipe.tracker.reset()
    pipe._gmc_reset()
    pipe.events = JaxZoneEventEngine.from_config(cfg.events,
                                                 trail_length=cfg.tracking.trail_length)
    return pipe


@pytest.fixture(scope="module")
def uninterrupted(clip, tmp_path_factory):
    """The JAX package's uninterrupted run: (log, zone_counts)."""
    log = str(tmp_path_factory.mktemp("jax") / "jax.jsonl")
    pipe = reference(log)
    pipe.run_chunked(clip)
    return log, pipe.events.zone_counts()


@pytest.fixture(scope="module")
def jax_half(clip, tmp_path_factory):
    """The JAX package's first half: its log so far and its snapshot."""
    d = tmp_path_factory.mktemp("jax_half")
    log, snap = str(d / "half.jsonl"), str(d / "state.npz")
    reference(log).run_chunked(clip, max_frames=HALF, state_path=snap)
    return log, snap


def _resume(make, clip, snap: str, log: str):
    """A fresh pipeline that restores ``snap`` and runs the rest of the file,
    appending to ``log``."""
    pipe = make(log)
    skip = pipe.load_runtime_state(snap)
    assert skip == HALF
    pipe.run_chunked(clip, state_path=snap, skip_frames=skip)
    with np.load(snap) as z:
        assert json.loads(str(z["meta"]))["frames_done"] == N_FRAMES
    return pipe


def test_port_uninterrupted_equals_the_jax_run(clip, uninterrupted, tmp_path):
    log = str(tmp_path / "port.jsonl")
    pipe = port(log)
    pipe.run_chunked(clip)
    assert_same_log(log, uninterrupted[0])
    assert pipe.events.zone_counts() == uninterrupted[1]


def test_port_resumed_equals_the_jax_uninterrupted_and_resumed_runs(clip, uninterrupted,
                                                                     jax_half, tmp_path):
    log, snap = str(tmp_path / "port.jsonl"), str(tmp_path / "state.npz")
    port(log).run_chunked(clip, max_frames=HALF, state_path=snap, state_interval=4)
    with np.load(snap) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["frames_done"] == HALF
    assert meta["events"]["log_offset"] == os.path.getsize(log)
    assert_same_log(log, jax_half[0])          # the halves agree before the restart
    pipe = _resume(port, clip, snap, log)
    assert_same_log(log, uninterrupted[0])
    assert pipe.events.zone_counts() == uninterrupted[1]
    # the JAX package's own resume of the same scenario
    jlog = str(tmp_path / "jax_resumed.jsonl")
    with open(jax_half[0]) as src, open(jlog, "w") as dst:
        dst.write(src.read())
    jsnap = str(tmp_path / "jax_state.npz")
    with open(jax_half[1], "rb") as src, open(jsnap, "wb") as dst:
        dst.write(src.read())
    _resume(reference, clip, jsnap, jlog)
    assert_same_log(log, jlog)


def test_a_jax_snapshot_resumed_by_the_port(clip, uninterrupted, jax_half, tmp_path):
    log, snap = str(tmp_path / "port.jsonl"), str(tmp_path / "state.npz")
    with open(jax_half[0]) as src, open(log, "w") as dst:
        dst.write(src.read())
    with open(jax_half[1], "rb") as src, open(snap, "wb") as dst:
        dst.write(src.read())
    pipe = _resume(port, clip, snap, log)
    assert_same_log(log, uninterrupted[0])
    assert pipe.events.zone_counts() == uninterrupted[1]


def test_a_port_snapshot_resumed_by_the_jax_package(clip, uninterrupted, tmp_path):
    log, snap = str(tmp_path / "mixed.jsonl"), str(tmp_path / "state.npz")
    port(log).run_chunked(clip, max_frames=HALF, state_path=snap)
    pipe = _resume(reference, clip, snap, log)
    assert_same_log(log, uninterrupted[0])
    assert pipe.events.zone_counts() == uninterrupted[1]


def test_clean_exit_snapshot_after_a_padded_chunk_equals_the_reference(clip, tmp_path):
    """14 frames: the last chunk carries two copies of frame 14, which both
    trackers have seen when the clean-exit snapshot is taken."""
    snaps = {}
    for name, make in (("port", port), ("jax", reference)):
        snaps[name] = str(tmp_path / f"{name}.npz")
        make(str(tmp_path / f"{name}.jsonl")).run_chunked(clip, max_frames=14,
                                                          state_path=snaps[name])
    with np.load(snaps["port"]) as zp, np.load(snaps["jax"]) as zj:
        mp, mj = json.loads(str(zp["meta"])), json.loads(str(zj["meta"]))
        assert mp["frames_done"] == mj["frames_done"] == 14
        assert mp["last_ts"] == mj["last_ts"]
        for key in zj.files:
            if not key.startswith("tracker/"):
                continue
            got, want = zp[key], zj[key]
            assert (got.shape, got.dtype) == (want.shape, want.dtype), key
            if got.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=key)
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
    mp["events"].pop("log_offset"), mj["events"].pop("log_offset")
    assert mp["events"]["counts"] == mj["events"]["counts"]
