"""``parallel.transport: bgr`` on the live per-frame loop: the port's
``Pipeline.run`` against the JAX package's.

With ``profiling.per_stage: false`` and nothing that asks for the chunked
path (``chunk_size: 1``), the reference's ``run`` takes its fused BGR
program for ``transport: bgr`` (``step`` at depth 0, ``submit`` with frames
in flight), not the packed I420 one.  The port must do the same: on
tests/test_torch_port_live.py's clip and config (rich640d at 256 px, float32,
zone events on) the tracks and the event log equal the JAX run's, to that
file's bars, at depth 0 and 2.
"""

from __future__ import annotations

import pytest

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.events.zone_engine import ZoneEventEngine as JaxZoneEventEngine
from rtmodt_tpu.runtime.pipeline import Pipeline as JaxPipeline
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.ops import nms_kernel
from rtmodt_tpu_torch.runtime.pipeline import Pipeline
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video
from tests.test_torch_port_live import FPS, H, N_FRAMES, W, assert_same_run, overrides, record
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

DEPTHS = (0, 2)


def bgr_overrides(log: str, depth: int) -> dict:
    return {**overrides(log, per_stage=False),
            "parallel": {"transport": "bgr", "chunk_size": 1, "pipeline_depth": depth}}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip25.mp4")
    write_synthetic_video(path, frames=N_FRAMES, h=H, w=W, n_objects=6, fps=FPS, seed=1)
    return path


@pytest.fixture(scope="module")
def jax_runs(clip, tmp_path_factory):
    """The JAX ``Pipeline.run`` at each depth: {depth: (frames, log, zone
    counts)}.  One pipeline serves both, so its fused program compiles once."""
    out, pipe = {}, None
    for depth in DEPTHS:
        log = str(tmp_path_factory.mktemp("ev") / f"jax{depth}.jsonl")
        cfg = jax_load_config(overrides=bgr_overrides(log, depth))
        if pipe is None:
            pipe = JaxPipeline(cfg)
            assert not pipe._use_packed_transport()
        pipe.cfg.parallel.pipeline_depth = depth
        pipe.events = JaxZoneEventEngine.from_config(cfg.events, trail_length=30)
        frames = record(pipe.tracker)
        pipe.run(clip)
        pipe.tracker.tracks_from_outputs = type(pipe.tracker).tracks_from_outputs.__get__(
            pipe.tracker)
        out[depth] = (frames, log, pipe.events.zone_counts())
    return out


def count_calls(monkeypatch, obj, name: str, calls: dict, key: str) -> None:
    inner = getattr(obj, name)

    def wrapped(*a, **kw):
        calls[key] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(obj, name, wrapped)


def test_bgr_per_frame_run_matches_the_jax_run(clip, jax_runs, tmp_path, monkeypatch):
    """One port pipeline at depth 0, then reset and at depth 2: every frame's
    tracks and the event log equal the JAX run's; the BGR letterbox ran once
    per frame and per warmup dummy, the packed program never; K1 ran its
    plain version on the CPU."""
    pipe = None
    calls = {"bgr": 0, "packed": 0}
    for depth in DEPTHS:
        log = str(tmp_path / f"port{depth}.jsonl")
        cfg = load_config(overrides=bgr_overrides(log, depth))
        if pipe is None:
            pipe = Pipeline(cfg)
            count_calls(monkeypatch, pipe.detector, "preprocess", calls, "bgr")
            count_calls(monkeypatch, pipe, "packed_detect", calls, "packed")
        else:
            pipe.cfg = cfg
            pipe.reset()
        calls.update(bgr=0, packed=0)
        frames = record(pipe.tracker)
        before = nms_kernel.launches
        pipe.run(clip)
        want_frames, want_log, want_counts = jax_runs[depth]
        assert_same_run(frames, log, want_frames, want_log)
        assert pipe.events.zone_counts() == want_counts
        assert calls == {"bgr": N_FRAMES + 3, "packed": 0}
        assert nms_kernel.launches == before              # the CPU runs the plain version
        pipe.tracker.tracks_from_outputs = type(pipe.tracker).tracks_from_outputs.__get__(
            pipe.tracker)
