"""The port's CLI (``tools/run_pipeline_torch.py``) against the reference's
(``tools/run_pipeline.py``).

Both run as subprocesses on one YAML (``system.device: cpu``,
``profiling.per_stage: true``, so that neither dispatches to its chunked
path) and one 25-fps clip, with the trained rich640d weights at 256 px in
float32.  Both must exit 0, print the final profile with the zone counts,
and write the same events: identical less the wall-clock ``timestamp_utc``,
``bbox_xyxy`` within 1e-4 px.  The flags that are not ported must exit
non-zero and name the ROADMAP item that will bring them.
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


@pytest.mark.parametrize("args,item", [
    (["--mjpeg-port", "0", "--resume-state", "state.npz"], "ROADMAP item 9"),
    (["--resume-state", "state.npz"], "ROADMAP item 9"),
    (["--state-interval", "10"], "ROADMAP item 9"),
    (["-s", "a.mp4", "-s", "b.mp4", "--resume-state", "state.npz"], "ROADMAP item 9"),
])
def test_cli_refuses_what_is_not_ported(args, item):
    from tools.run_pipeline_torch import main

    with pytest.raises(SystemExit) as exc:
        main(args)
    assert item in str(exc.value.code)
