#!/usr/bin/env python
"""End-to-end self-test of the PyTorch/CUDA port: train a detector from
scratch, then detect + track and score IDF1 / MOTA, with the port's own
components only.

The port's counterpart of ``tools/selftest_e2e.py``: it writes the synthetic
set (``tools/make_dataset_torch.py``: 64 train / 16 val frames at 320x320,
3 objects), trains YOLOv8n at 320 from scratch in float32
(``training/trainer.py``, the reference's selftest config), runs
``tools/run_inference_torch.py track --gt-mot`` over the val sequence and
passes when IDF1 and MOTA both reach ``--idf1-min`` (expected: 1.0 / 1.0).
The card by default; ``--cpu`` runs on the CPU.  The last line of its
output is a JSON summary: the metrics, the seconds of each part, and K1's
launches in the validation and in the track run.

    python tools/selftest_e2e_torch.py [--steps 320] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def selftest_config(work: str, data: str) -> dict:
    """The reference selftest's training config."""
    return {
        "model": "yolov8n", "num_classes": 1, "input_size": 320,
        "data": {"root": data, "train_split": "train", "val_split": "val", "max_boxes": 8},
        "epochs": 40, "batch_size": 8, "steps_per_epoch": 8,
        "optimizer": {"lr0": 0.002, "lrf": 0.05, "weight_decay": 0.0005,
                      "warmup_epochs": 2, "clip_norm": 10.0},
        "loss": {"box": 7.5, "cls": 0.5, "dfl": 1.5},
        "augmentation": {"mosaic": 0.5, "fliplr": 0.5, "hsv_h": 0.01, "hsv_s": 0.3,
                         "hsv_v": 0.2, "scale": 0.3, "translate": 0.1},
        "precision": "fp32", "ema_decay": 0.999,
        "checkpoint": {"dir": os.path.join(work, "ckpt"), "save_period": 10, "resume": False},
        "patience": 0, "val_interval": 5, "parallel": {"num_devices": 0},
    }


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--steps", default=320, type=int)
    ap.add_argument("--idf1-min", default=0.95, type=float)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    import torch

    from rtmodt_tpu_torch.device import resolve_device
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.training.trainer import Trainer
    from tools import run_inference_torch

    a = parse_args(argv)
    resolve_device("cpu" if a.cpu else "cuda")     # no card: raise before any work
    t0 = time.perf_counter()
    work = a.workdir or tempfile.mkdtemp(prefix="rtmodt_selftest_")
    data = os.path.join(work, "synthetic")
    cmd = [sys.executable, "tools/make_dataset_torch.py", "--dataset", "synthetic",
           "--root", work, "--n-train", "64", "--n-val", "16", "--height", "320",
           "--width", "320", "--objects", "3"]
    print("$ " + " ".join(cmd), flush=True)
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    if r.returncode != 0:
        print(r.stdout[-2000:], r.stderr[-2000:], file=sys.stderr)
        return 1
    t_data = time.perf_counter() - t0

    if not a.cpu:
        # the reference trains and tracks in full float32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    launches0 = nms_kernel.launches
    trainer = Trainer(selftest_config(work, data), "cpu" if a.cpu else "cuda")
    trainer.fit(a.steps)
    t_train = time.perf_counter() - t0 - t_data
    val_launches = nms_kernel.launches - launches0

    weights = os.path.join(work, "ckpt", "ema_final.npz")
    if not os.path.exists(weights):
        print("training did not produce EMA weights", file=sys.stderr)
        return 1
    launches0 = nms_kernel.launches
    t1 = time.perf_counter()
    track_argv = ["track", "--video", os.path.join(data, "images", "val"),
                  "--model", "yolov8n", "--weights", weights, "--num-classes", "1",
                  "--input-size", "320", "--conf", "0.5", "--match-thresh", "0.3",
                  "--out", os.path.join(work, "pred_tracks.txt"),
                  "--gt-mot", os.path.join(data, "val_mot_gt.txt")] + (["--cpu"] if a.cpu else [])
    result = run_inference_torch.track(run_inference_torch.parse_args(track_argv))
    t_track = time.perf_counter() - t1
    ok = result["idf1"] >= a.idf1_min and result["mota"] >= a.idf1_min
    print(("SELFTEST PASSED" if ok else "SELFTEST FAILED")
          + f" (idf1={result['idf1']:.3f}, mota={result['mota']:.3f}, min {a.idf1_min})",
          flush=True)
    print(json.dumps({"ok": ok, "idf1": result["idf1"], "mota": result["mota"],
                      "steps": trainer.state.step, "seconds": time.perf_counter() - t0,
                      "data_s": t_data, "train_s": t_train, "track_s": t_track,
                      "k1_val_launches": val_launches,
                      "k1_track_launches": nms_kernel.launches - launches0}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
