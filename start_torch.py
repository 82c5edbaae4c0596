#!/usr/bin/env python
"""One-click launcher of the PyTorch/CUDA port's web UI.

The same steps as ``start.py``: checks that the port's core modules import,
ensures the sample gallery exists (>= 3 images), frees the port if a stale
server holds it, and launches the port's web server
(``rtmodt_tpu_torch.serving.server``) on ``$PORT`` (default 8000;
containers set 7860).  The detector is built on the card at the first
request (``RTMODT_MODEL``, ``RTMODT_WEIGHTS``).

    python start_torch.py
"""

from __future__ import annotations

import importlib
import os
import signal
import subprocess
import sys

CORE_MODULES = [
    "rtmodt_tpu_torch.detection.detector",
    "rtmodt_tpu_torch.tracking.tracker",
    "rtmodt_tpu_torch.events.zone_engine",
    "rtmodt_tpu_torch.ingestion.rtsp_reader",
    "rtmodt_tpu_torch.visualization.renderer",
    "rtmodt_tpu_torch.profiling.latency_profiler",
    "rtmodt_tpu_torch.serving.server",
]


def check_imports() -> bool:
    ok = True
    for mod in CORE_MODULES:
        try:
            importlib.import_module(mod)
        except Exception as e:
            print(f"[start] FAILED import {mod}: {e}")
            ok = False
    return ok


def ensure_samples(count: int = 8) -> None:
    """Render the synthetic sample gallery (the scenes that
    ``tools/download_samples.py`` falls back to) when it holds fewer than 3
    images; nothing is fetched over the network."""
    samples = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "web", "static", "samples")
    n = len([f for f in os.listdir(samples)]) if os.path.isdir(samples) else 0
    if n >= 3:
        return
    print("[start] rendering the synthetic sample gallery...")
    import cv2

    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    os.makedirs(samples, exist_ok=True)
    for i in range(count):
        dest = os.path.join(samples, f"synthetic_scene_{i + 1}.jpg")
        if not os.path.exists(dest):
            frame, _ = moving_boxes_frame(i * 13, 720, 1280, n_objects=4 + i % 4, seed=i)
            cv2.imwrite(dest, frame)


def free_port(port: int) -> None:
    """Kill a stale listener on the port (POSIX; reference does this for
    Windows via netstat/taskkill, start.py:27-43)."""
    try:
        out = subprocess.run(["fuser", f"{port}/tcp"], capture_output=True,
                             text=True, timeout=5)
        for pid in out.stdout.split():
            if pid.strip().isdigit() and int(pid) != os.getpid():
                print(f"[start] freeing port {port} (pid {pid})")
                os.kill(int(pid), signal.SIGTERM)
    except (FileNotFoundError, subprocess.TimeoutExpired, ProcessLookupError):
        pass


def main() -> None:
    print("=" * 60)
    print(" RTMODT - Real-Time Multi-Object Detection & Tracking (PyTorch/CUDA)")
    print("=" * 60)
    if not check_imports():
        print("[start] import check failed; fix the environment first")
        sys.exit(1)
    ensure_samples()
    port = int(os.environ.get("PORT", "8000"))
    free_port(port)
    print(f"[start] launching web UI on 0.0.0.0:{port}")
    from rtmodt_tpu_torch.serving.server import app
    from rtmodt_tpu_torch.serving.wsgi import run_server

    run_server(app, "0.0.0.0", port)


if __name__ == "__main__":
    main()
