"""The port's CLI (``tools/run_pipeline_torch.py``) against the reference's
(``tools/run_pipeline.py``).

Both run as subprocesses on one YAML (``system.device: cpu``,
``profiling.per_stage: true``, so that neither dispatches to its chunked
path) and one 25-fps clip, with the trained rich640d weights at 256 px in
float32.  Both must exit 0, print the final profile with the zone counts,
and write the same events: identical less the wall-clock ``timestamp_utc``,
``bbox_xyxy`` within 1e-4 px.  ``--resume-state`` writes a snapshot and a
second run advances it, with one and with several ``-s``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "checkpoints", "rich640d", "ema_final.npz")
N_FRAMES, FPS = 14, 25.0


def _config(tmp, name: str) -> str:
    cfg = {
        "system": {"device": "cpu", "log_dir": str(tmp / f"logs_{name}")},
        "detection": {"model": "yolov8s", "input_size": 256, "num_classes": 8,
                      "weights": WEIGHTS, "half": False},
        "events": {"zones": [
            {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
             "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2},
            {"name": "gate", "polygon": [[120, 0], [512, 0], [512, 288], [120, 288]],
             "trigger": "crossing", "cooldown_sec": 1.0}],
            "alert": {"backend": "json_file", "log_path": str(tmp / f"{name}.jsonl")}},
        "profiling": {"per_stage": True, "warmup_frames": 2, "log_interval": 0},
        "visualization": {"enabled": True},
    }
    path = tmp / f"{name}.yaml"
    path.write_text(json.dumps(cfg))          # JSON is YAML
    return str(path)


def _cli(tool: str, *args: str, timeout: int = 600) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, os.path.join(ROOT, "tools", tool), *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def _events(path: str) -> list[dict]:
    with open(path) as f:
        out = [json.loads(line) for line in f]
    for e in out:
        e.pop("timestamp_utc")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    clip = str(tmp / "clip25.mp4")
    write_synthetic_video(clip, frames=N_FRAMES, h=288, w=512, n_objects=6, fps=FPS, seed=1)
    port = _cli("run_pipeline_torch.py", "-c", _config(tmp, "port"), "-s", clip,
                "--no-display")
    ref = _cli("run_pipeline.py", "-c", _config(tmp, "ref"), "-s", clip, "--no-display")
    return tmp, port, ref


def test_cli_writes_the_same_events_as_the_reference_cli(runs):
    tmp, port, ref = runs
    assert port.returncode == 0, port.stderr[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    got, want = _events(str(tmp / "port.jsonl")), _events(str(tmp / "ref.jsonl"))
    assert len(want) > 0 and len(got) == len(want)
    got_boxes = np.array([e.pop("bbox_xyxy") for e in got])
    want_boxes = np.array([e.pop("bbox_xyxy") for e in want])
    assert got == want
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=1e-4)


def test_cli_prints_the_final_profile_and_zone_counts(runs):
    tmp, port, ref = runs

    def profile(proc):
        text = proc.stdout.split("=== final profile ===")[1]
        return {line.split(":")[0].strip() for line in text.strip().splitlines()}

    assert profile(port) == profile(ref)
    assert "zone_counts" in profile(port) and "nms_mean_ms" in profile(port)
    zc = [line for line in port.stdout.splitlines() if "zone_counts" in line]
    assert zc == [line for line in ref.stdout.splitlines() if "zone_counts" in line]
    assert os.path.exists(tmp / "logs_port" / "pipeline.log")


@pytest.fixture(scope="module")
def resume_setup(tmp_path_factory):
    """A 16-frame clip and a config for the resume cases: yolov8n at 128
    (random weights, conf 0.01), the chunked path, one zone."""
    tmp = tmp_path_factory.mktemp("resume")
    clip = str(tmp / "clip.mp4")
    write_synthetic_video(clip, frames=16, h=160, w=160, n_objects=2)
    cfg = tmp / "cfg.yaml"
    cfg.write_text(json.dumps({
        "system": {"device": "cpu", "log_dir": str(tmp / "logs")},
        "detection": {"model": "yolov8n", "input_size": 128, "conf_threshold": 0.01,
                      "nms_candidates": 64, "max_detections": 20, "half": False},
        "events": {"alert": {"log_path": str(tmp / "cli.jsonl")},
                   "zones": [{"name": "z", "polygon": [[10, 10], [150, 10], [150, 150],
                                                        [10, 150]],
                              "dwell_time_sec": 0.0, "cooldown_sec": 0.5}]},
        "profiling": {"warmup_frames": 0, "log_interval": 0, "per_stage": False},
        "parallel": {"chunk_size": 4, "pipeline_depth": 1},
        "visualization": {"enabled": False}}))
    return str(cfg), clip


@pytest.mark.parametrize("args,streams", [
    (["--mjpeg-port", "0", "--resume-state", "state.npz"], 1),
    (["--resume-state", "state.npz"], 1),
    (["--state-interval", "4", "--resume-state", "state.npz"], 1),
    (["--resume-state", "state.npz"], 2),
])
def test_cli_refuses_what_is_not_ported(resume_setup, tmp_path, monkeypatch, args, streams):
    """The four cases that exited non-zero before kill-and-resume was ported
    (ROADMAP item 9), now showing the flags at work; no flag of the CLI is
    refused any more.  As tests/test_state_resume.py's CLI case: the first run stops at 8
    frames with a snapshot of them, the second resumes from it and advances
    it to the end of the file (one stream: the per-frame path behind the
    MJPEG monitor, or the chunked path; two streams: the multi-camera
    loop).  ``--state-interval 4`` adds a snapshot once 4 frames are
    consumed, at a drained window: 8 frames with one chunk in flight."""
    from rtmodt_tpu_torch.runtime import state_store
    from tools.run_pipeline_torch import main

    cfg, clip = resume_setup
    snap = str(tmp_path / "state.npz")
    argv = ["-c", cfg, *[a for _ in range(streams) for a in ("-s", clip)],
            *[snap if a == "state.npz" else a for a in args]]
    saved = []
    inner = state_store.save_snapshot
    monkeypatch.setattr(state_store, "save_snapshot",
                        lambda *a, **kw: (saved.append(kw["frames_done"]), inner(*a, **kw)))

    def progress():
        with np.load(snap) as z:
            meta = json.loads(str(z["meta"]))
        return meta.get("per_stream_frames", [meta.get("frames_done")])

    assert main(argv + ["--max-frames", "8"]) == 0
    assert progress() == [8] * streams
    if streams == 1:
        # at exit, and with --state-interval 4 at the drained window too
        assert saved == ([8, 8] if "--state-interval" in args else [8])
    assert main(argv) == 0
    assert progress() == [16] * streams
