"""The port's ``LatencyProfiler`` and its config sections against the
reference package's.

The same tick/tock/end_frame sequence under the same faked clock must give
the same ``summary()`` (keys and values exact), ``current_fps`` and printed
table.  The ``system``, ``ingestion``, ``profiling`` and ``visualization``
defaults must equal the reference's ``default.yaml``; values the port
cannot honour must raise, naming the ROADMAP item that will bring them.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu.profiling.latency_profiler import LatencyProfiler as JaxProfiler
from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.device import config_device
from rtmodt_tpu_torch.profiling.latency_profiler import STAGES, LatencyProfiler
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)


def _drive(profiler, sync, monkeypatch, n_frames=40):
    """A seeded sequence of stage durations on a fake clock."""
    rng = np.random.default_rng(7)
    steps = iter(rng.uniform(1e-4, 2e-2, 100_000))
    clock = itertools.accumulate(steps)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    fps = []
    for _ in range(n_frames):
        for stage in STAGES:
            profiler.tick(stage)
            profiler.tock(stage, sync_on=sync if stage in ("preprocess", "nms") else None)
        profiler.end_frame()
        fps.append(profiler.current_fps)
    return profiler.summary(), fps, profiler.print_summary()


@pytest.mark.parametrize("warmup", [0, 5, 50])
def test_summary_matches_the_reference_under_a_fake_clock(warmup, monkeypatch):
    got = _drive(LatencyProfiler(warmup_frames=warmup, log_interval=7),
                 (torch.zeros(3), [torch.ones(2)]), monkeypatch)
    want = _drive(JaxProfiler(warmup_frames=warmup, log_interval=7),
                  (jnp.zeros(3), [jnp.ones(2)]), monkeypatch)
    assert got == want
    if warmup < 40:
        assert set(got[0]) == {f"{s}_{m}_ms" for s in (*STAGES, "total", "frame")
                               for m in ("mean", "p95", "p99")} | {"fps_mean", "fps_p5"}
    else:
        assert got[0] == {}


def test_disabled_profiler_records_nothing(monkeypatch):
    p = LatencyProfiler(enabled=False)
    summary, fps, text = _drive(p, None, monkeypatch, n_frames=3)
    assert summary == {} and fps == [0.0] * 3 and p.frame_count == 0


def test_new_sections_default_to_the_reference_default_yaml():
    port, ref = load_config(), jax_load_config()
    for name in ("system", "ingestion", "profiling", "visualization"):
        section = getattr(port, name)
        for f in dataclasses.fields(section):
            assert getattr(section, f.name) == getattr(getattr(ref, name), f.name), f.name


@pytest.mark.parametrize("overrides,match", [
    ({"profiling": {"trace_dir": "traces"}}, "ROADMAP item 12"),
    ({"visualization": {"mjpeg_port": 70000}}, "visualization.mjpeg_port"),
    ({"system": {"device": "gpu"}}, "system.device"),
    ({"ingestion": {"backend": "ffmpeg"}}, "ingestion.backend"),
    ({"ingestion": {"resolution": [640]}}, "ingestion.resolution"),
])
def test_unported_or_bad_values_raise(overrides, match):
    with pytest.raises(ValueError, match=match):
        load_config(overrides=overrides)


def test_reference_only_keys_are_dropped():
    cfg = load_config(overrides={"system": {"precision": "fp32", "output_dir": "out"},
                                 "ingestion": {"buffer_size": 4},
                                 "profiling": {"trace_frames": 5}})
    assert not hasattr(cfg.system, "precision")
    assert not hasattr(cfg.system, "output_dir")
    assert not hasattr(cfg.ingestion, "buffer_size")


@pytest.mark.parametrize("name,want", [("tpu", "cuda"), ("cuda", "cuda"), ("CPU", "cpu"),
                                       ("cpu", "cpu")])
def test_system_device_names_the_card_or_the_cpu(name, want):
    assert config_device(name) == want
