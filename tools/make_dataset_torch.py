#!/usr/bin/env python
"""Write a synthetic dataset with the PyTorch/CUDA port's generators.

The offline branches of ``tools/download_dataset.py`` with its flags, byte
for byte: ``--dataset synthetic`` writes a YOLO-layout set with COCO (and,
with one class, MOT) ground truth under ``ROOT/synthetic`` (``--classes
N > 1``: the rich multi-class set under ``ROOT/synthetic_rich``);
``--dataset dense-mot`` writes a dense tracking sequence under
``ROOT/dense_mot_<objects>``.  The download branches need the network and
are not here.

    python tools/make_dataset_torch.py --dataset synthetic --classes 8 --n-train 64 --n-val 16
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=["synthetic", "dense-mot"], default="synthetic")
    ap.add_argument("--root", default="data")
    ap.add_argument("--n-train", default=200, type=int)
    ap.add_argument("--n-val", default=50, type=int)
    ap.add_argument("--height", default=720, type=int)
    ap.add_argument("--width", default=1280, type=int)
    ap.add_argument("--objects", default=6, type=int)
    ap.add_argument("--classes", default=1, type=int,
                    help="> 1: multi-class cluttered scenes (utils/synthetic.py::"
                         "cluttered_scene) instead of the moving-boxes scene")
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--frames", default=120, type=int,
                    help="sequence length for --dataset dense-mot")
    ap.add_argument("--dense-frac", default=0.0, type=float,
                    help="fraction of rich-synthetic images rendered as dense "
                         "small-object crowd frames (720x1280, 24-64 objects)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    from rtmodt_tpu_torch.training.synth_data import (make_dense_mot, make_synthetic,
                                                      make_synthetic_rich)

    a = parse_args(argv)
    if a.dataset == "dense-mot":
        make_dense_mot(os.path.join(a.root, f"dense_mot_{a.objects}"), a.frames,
                       a.height, a.width, a.objects, a.seed)
    elif a.classes > 1:
        make_synthetic_rich(os.path.join(a.root, "synthetic_rich"), a.n_train, a.n_val,
                            a.height, a.width, a.classes, a.seed, dense_frac=a.dense_frac)
    else:
        make_synthetic(os.path.join(a.root, "synthetic"), a.n_train, a.n_val,
                       a.height, a.width, a.objects, a.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
