#!/usr/bin/env python
"""Model export tool of the port.

The port's counterpart of ``tools/export_model.py``, with its flags
(argparse), plus ``--num-classes``, ``--seed`` and ``--device`` (the card by
default).  It builds the port's ``Detector`` (BN folded, as the reference's
default ``fuse_bn`` does) and writes:

  * ``npz``    - the reference's flat weights (``models/weights.py::
    save_npz``), the file the JAX ``Detector`` loads: the folded float32
    parameters, or with ``--half`` their bf16 rounding, which the reference
    writes as bf16 and the port as the same values in float32 (a dtype the
    reference's loader reads);
  * ``export`` - the counterpart of ``stablehlo``: a ``torch.export``
    program of the deployed forward (bf16 under ``--half``, float32 under
    ``--no-half``), saved with ``torch.export.save`` as a ``.pt2``.  Its
    input is the reference's spec, NHWC ``(batch, imgsz, imgsz, 3)`` in the
    compute dtype, with the NCHW permute inside the program, so a caller
    passes either artifact the same array; it returns the raw heads (box
    distributions, class logits).  ``torch.export.load(path).module()``
    runs it without the port's model code;
  * ``orbax`` is a JAX checkpoint format with no writer on a machine
    without JAX: it raises.

Weights come from ``--weights`` (``.npz``, or an ultralytics ``.pt``), or
are drawn at random from an explicit ``--seed``.

    python tools/export_model_torch.py -w checkpoints/rich640d/ema_final.npz \\
        --num-classes 8 -f export --batch 16 [-o out.pt2] [--no-half] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export_module(model, channels_last: bool):
    """The deployed forward with NHWC input: the permute to NCHW inside."""
    import torch

    class NHWCForward(torch.nn.Module):
        def __init__(self, inner: torch.nn.Module):
            super().__init__()
            self.inner = inner

        def forward(self, img: torch.Tensor):
            x = img.permute(0, 3, 1, 2)
            # NHWC storage is a channels_last NCHW tensor: no copy; the
            # CPU model takes contiguous NCHW
            return self.inner(x if channels_last else x.contiguous())

    return NHWCForward(model).eval()


def export(model_name: str = "yolov8s", weights: str | None = None, fmt: str = "npz",
           imgsz: int = 640, half: bool = True, batch: int = 1, out: str | None = None,
           num_classes: int = 80, seed: int | None = None, device: str = "cuda") -> str:
    """Write the export; returns its path."""
    import torch

    from rtmodt_tpu_torch.config.loader import DetectionConfig, is_rtdetr
    from rtmodt_tpu_torch.detection.detector import Detector
    from rtmodt_tpu_torch.models.weights import save_npz
    from rtmodt_tpu_torch.utils.logging import logger

    if fmt == "orbax":
        raise ValueError("orbax is a JAX checkpoint format: no writer exists on a machine "
                         "without JAX; export npz (which the JAX package loads) instead")
    if fmt not in ("npz", "export"):
        raise ValueError(f"unknown format {fmt!r} (npz | export | orbax)")
    if is_rtdetr(model_name):
        raise ValueError(f"export writes YOLOv8 only: the reference's npz and the NHWC "
                         f"head export have no layout for {model_name}")
    if weights is None and seed is None:
        raise ValueError("give --weights, or --seed for random weights")
    det = Detector(DetectionConfig(model=model_name, weights=weights, input_size=imgsz,
                                   half=half, num_classes=num_classes),
                   device=device, warmup=False, seed=seed or 0)
    out = out or f"{model_name}_{imgsz}.{'npz' if fmt == 'npz' else 'pt2'}"
    if fmt == "npz":
        # the deployed model: folded, and rounded to bf16 under half
        save_npz(det.model, out)
    else:
        example = torch.zeros((batch, imgsz, imgsz, 3), dtype=det.dtype, device=det.device)
        mod = export_module(det.model, det.device.type == "cuda")
        with torch.no_grad():
            program = torch.export.export(mod, (example,))
        # the archive would keep the zero example input (batch x imgsz^2 x 3
        # elements, 39 MB at B = 16, 640, bf16) beside the weights
        program.example_inputs = None
        torch.export.save(program, out)
    logger.info(f"exported {model_name} ({fmt}) -> {out}")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", "-w", default=None,
                    help="source weights (.npz or .pt); without them, --seed")
    ap.add_argument("--model", default="yolov8s")
    ap.add_argument("-f", "--format", dest="fmt", default="npz",
                    choices=["npz", "orbax", "export"])
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--half", dest="half", action="store_true", default=True,
                    help="bf16 compute (default)")
    ap.add_argument("--no-half", dest="half", action="store_false",
                    help="float32 compute")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--out", "-o", default=None, help="output path")
    ap.add_argument("--num-classes", type=int, default=80,
                    help="head class count of the weights (rich* checkpoints: 8)")
    ap.add_argument("--seed", type=int, default=None, help="random weights from this seed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(export(args.model, args.weights, args.fmt, args.imgsz, args.half, args.batch,
                 args.out, args.num_classes, args.seed, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
