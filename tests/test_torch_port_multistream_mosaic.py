"""The multi-camera mosaic over several ranks (``MultiStreamPipeline.run``
with ``visualization.save_video`` on a ``parallel/mesh.py`` mesh) against one
process, and the CLI's ``--save-video`` over two ranks.

Four 25-fps clips of 512x288 (12 frames; the third 6, so that its tile goes
black half-way) at S = 4, T = 4 with yolov8n at 128 px (seeded weights,
conf 0.01, float32), zone events on, the HUD off (it prints the wall-clock
fps).  Each rank draws its two streams' tiles and rank 0 tiles and writes
them: the video's decoded frames must equal one process's, frame by frame.
The reference draws the mosaic over any mesh
(``rtmodt_tpu/parallel/multistream.py``); its mosaic is held to the port's
in tests/test_torch_port_multistream.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from rtmodt_tpu_torch.config import load_config
from rtmodt_tpu_torch.parallel import mesh as M
from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline
from rtmodt_tpu_torch.parallel.ranks import multistream_run
from rtmodt_tpu_torch.utils.synthetic import write_synthetic_video
from tests.test_torch_port_threads import child_env, torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, SIZE, T, N, S = 288, 512, 128, 4, 12, 4


def overrides(tmp, video: str) -> dict:
    return {
        "system": {"device": "cpu", "log_dir": str(tmp / "logs")},
        "ingestion": {"max_reconnects": 0},
        "detection": {"model": "yolov8n", "input_size": SIZE, "conf_threshold": 0.01,
                      "classes": None, "nms_candidates": 64, "max_detections": 20,
                      "half": False},
        "events": {"zones": [
            {"name": "left_half", "polygon": [[0, 0], [256, 0], [256, 288], [0, 288]],
             "trigger": "intrusion", "dwell_time_sec": 0.12, "cooldown_sec": 0.2}],
            "alert": {"backend": "json_file", "log_path": str(tmp / f"{video}.jsonl")}},
        "parallel": {"chunk_size": T, "pipeline_depth": 1},
        "visualization": {"enabled": True, "show_hud": False, "save_video": True,
                          "save_path": str(tmp / f"{video}.mp4")},
    }


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    out = []
    for i, n in enumerate((N, N, N // 2, N)):
        path = str(d / f"cam{i}.mp4")
        write_synthetic_video(path, frames=n, h=H, w=W, n_objects=6, fps=25.0, seed=1 + i)
        out.append(path)
    return out


def decoded(path: str) -> list[np.ndarray]:
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def assert_same_frames(got: list[np.ndarray], want: list[np.ndarray]) -> None:
    assert len(got) == len(want) == N
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (2 * H, 2 * W, 3)
        assert np.array_equal(g, w), (f"mosaic frame {i}: {int((g != w).any(-1).sum())} "
                                      "pixels differ")


def test_mosaic_over_two_ranks_equals_one_process(clips, tmp_path):
    cfg_one = load_config(overrides=overrides(tmp_path, "one"))
    want_sum = MultiStreamPipeline(cfg_one, num_streams=S, device="cpu").run(
        clips, chunk_size=T)
    out = M.spawn(multistream_run, M.create_mesh(devices=["cpu", "cpu"]),
                  load_config(overrides=overrides(tmp_path, "two")), clips,
                  {"chunk_size": T}, timeout=240)
    got_sum = out[0]["summary"]
    assert out[1]["summary"] is None
    assert got_sum["per_stream_frames"] == want_sum["per_stream_frames"] == [N, N, N // 2, N]
    assert got_sum["zone_counts"] == want_sum["zone_counts"]
    want = decoded(str(tmp_path / "one.mp4"))
    assert_same_frames(decoded(str(tmp_path / "two.mp4")), want)
    # the third stream's tile (row 1, column 0) goes black once its clip
    # ends, right of its zone (the left half, filled) but for the coasting
    # tracks drawn on it; while it runs it is a frame, as the others stay
    def black(f, row, col):
        return (f[row * H:(row + 1) * H, col * W + W // 2:(col + 1) * W] < 16).all(-1).mean()

    assert [black(f, 1, 0) > 0.6 for f in want] == [False] * (N // 2) + [True] * (N // 2)
    assert all(black(f, r, c) < 0.1 for f in want for r, c in ((0, 0), (0, 1), (1, 1)))


def test_cli_saves_the_mosaic_over_two_cpu_ranks(clips, tmp_path):
    """``run_pipeline_torch -s ... --save-video`` with the ranks named by
    ``RTMODT_MESH_DEVICES``: it no longer exits, and rank 0 writes the video
    of one process's run."""
    runs = {}
    for name, devices in (("cli_two", "cpu,cpu"), ("cli_one", None)):
        path = tmp_path / f"{name}.yaml"
        path.write_text(json.dumps(overrides(tmp_path, name)))   # JSON is YAML
        env = child_env()
        env.pop(M.ENV_DEVICES, None)
        if devices:
            env[M.ENV_DEVICES] = devices
        argv = [sys.executable, os.path.join(ROOT, "tools", "run_pipeline_torch.py"), "-c",
                str(path), "--save-video", "--max-frames", str(T)]
        for clip in clips:
            argv += ["-s", clip]
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600,
                              env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert ("one rank each" in proc.stderr) == bool(devices)
        assert f"per_stream_frames: {[T] * S}" in proc.stdout
        runs[name] = decoded(str(tmp_path / f"{name}.mp4"))
    assert len(runs["cli_two"]) == T
    for i, (g, w) in enumerate(zip(runs["cli_two"], runs["cli_one"])):
        assert g.shape == (2 * H, 2 * W, 3) and np.array_equal(g, w), f"frame {i}"
