#!/usr/bin/env python
"""Train YOLOv8 with the PyTorch/CUDA port on one card.

The port's counterpart of ``tools/train.py``, with its flags: YoloDataset
(mosaic augmentation) -> the train step -> EMA -> validation mAP50 (K1 at
K = 1000 per val image) -> checkpoints with best-by-mAP50 retention and
early stopping -> ``ema_final.npz``; ``--qat-steps N`` then folds BN and
fine-tunes through int8 rounding (``qat_final.npz`` + ``qat_act_scales.npz``
for ``detection.quant: int8`` with ``quant_scales``).  Besides the
reference's flags: ``--weights`` starts from a reference ``.npz`` (BN
unfused) instead of the from-scratch init, and ``--device cpu`` runs on
the CPU; the card is the default.  ``parallel.num_devices`` in the YAML
(absent or 0: every card) trains data-parallel over that many cards, one
rank each (with ``--device cpu``, that many CPU ranks over gloo).

    python tools/train_torch.py -c rtmodt_tpu_torch/config/training_rich640d.yaml --max-steps 100
    python tools/train_torch.py -c tiny.yaml --max-steps 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", dest="config_path", default=None,
                    help="training YAML (default: the port's config/training.yaml)")
    ap.add_argument("--epochs", default=None, type=int)
    ap.add_argument("--batch", dest="batch_size", default=None, type=int)
    ap.add_argument("--imgsz", default=None, type=int)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-steps", default=None, type=int, help="hard stop (debug)")
    ap.add_argument("--qat-steps", default=0, type=int,
                    help="after training: fold BN and run N quantization-aware "
                         "fine-tune steps; saves qat_final.npz + qat_act_scales.npz")
    ap.add_argument("--compare-raw", action="store_true",
                    help="each validation also evaluates the raw (non-EMA) parameters")
    ap.add_argument("--weights", default=None,
                    help="initial weights: a reference .npz with BN unfused")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    from rtmodt_tpu_torch.training.trainer import load_train_config, train

    a = parse_args(argv)
    cfg = load_train_config(a.config_path, a.epochs, a.batch_size, a.imgsz, a.data_root,
                            a.resume)
    try:
        train(cfg, a.device, weights=a.weights, max_steps=a.max_steps, qat_steps=a.qat_steps,
              compare_raw=a.compare_raw)
    except (RuntimeError, ValueError, FileNotFoundError) as e:
        raise SystemExit(f"train_torch: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
