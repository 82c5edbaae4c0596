"""YOLOv8 (Ultralytics ``cfg/models/v8/yolov8.yaml``), the architecture of
every configuration file without an ``arch`` key.

The harness's interface (``perfbench/manifest.py::arch_module``) over the
code it has for this architecture: the operation count of
``perfbench/flops.py``, the plain reference of
``perfbench/reference/yolo.py`` and the int8 control of
``perfbench/control.py``; and seeded weights in the checkpoint layout the
program and the reference both read."""

from __future__ import annotations

import os

import numpy as np
import torch

from perfbench import control, flops
from perfbench.reference import yolo

# greedy class-aware suppression at the configuration's iou_threshold (K1)
SUPPRESSED = True

detect = yolo.detect
control_config = control.int8_config
control_detector = control.int8_detector


def forward_flops(conf: dict) -> float:
    return flops.forward_flops(conf, conf["pipeline"]["detection"]["input_size"])


def load_reference(conf: dict, weights_path: str, device: torch.device) -> yolo.PlainYOLOv8:
    return yolo.PlainYOLOv8(weights_path, device)


def conv_names(conf: dict) -> list[str]:
    """The checkpoint's name of each convolution, in ``flops.conv_shapes``'
    order; the head's last 1x1 convs (with a bias, no BN) as ``box<i>_2`` and
    ``cls<i>_2``."""
    rep = lambda n: max(round(n * conf["depth_multiple"]), 1)  # noqa: E731
    out: list[str] = []

    def c2f(name: str, n: int) -> None:
        out.append(f"{name}/cv1")
        for i in range(n):
            out.extend((f"{name}/m{i}/cv1", f"{name}/m{i}/cv2"))
        out.append(f"{name}/cv2")

    out.extend(("stem", "down1"))
    for name, down, n in (("c2f1", None, 3), ("c2f2", "down2", 6), ("c2f3", "down3", 6),
                          ("c2f4", "down4", 3)):
        if down:
            out.append(down)
        c2f(name, rep(n))
    out.extend(("sppf/cv1", "sppf/cv2"))
    c2f("neck_td4", rep(3))
    c2f("neck_td3", rep(3))
    out.append("neck_dn3")
    c2f("neck_bu4", rep(3))
    out.append("neck_dn4")
    c2f("neck_bu5", rep(3))
    for i in range(3):
        out.extend((f"head/box{i}_0", f"head/box{i}_1", f"box{i}_2",
                    f"head/cls{i}_0", f"head/cls{i}_1", f"cls{i}_2"))
    return out


def leaves(conf: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(key, shape) of every array of the flat ``.npz`` checkpoint (conv
    kernels HWIO; BN scale, bias, mean and var)."""
    shapes = flops.conv_shapes(conf, conf["pipeline"]["detection"]["input_size"])
    names = conv_names(conf)
    if len(names) != len(shapes):
        raise ValueError(f"{len(names)} conv names for {len(shapes)} convolutions")
    out = []
    for name, (c1, c2, k, _) in zip(names, shapes):
        if name.endswith("_2") and "/" not in name:      # the head's last 1x1 convs
            out += [(f"params/head/{name}/kernel", (k, k, c1, c2)),
                    (f"params/head/{name}/bias", (c2,))]
            continue
        out.append((f"params/{name}/conv/kernel", (k, k, c1, c2)))
        out += [(f"params/{name}/bn/{p}", (c2,)) for p in ("scale", "bias")]
        out += [(f"batch_stats/{name}/bn/{p}", (c2,)) for p in ("mean", "var")]
    return out


# Random layers with BN near identity shrink the features (SiLU's slope is
# 1/2 near 0) and a larger gain in the body makes them blow up, so only the
# head's last convs get one: the logits spread by ~2 and a few per cent of
# the anchors pass a confidence gate of ~0.35 (sigmoid(-0.62)).
HEAD_GAIN = 20.0
CLS_BIAS = -4.0


def seeded_weights(conf: dict, seed: int, stem: str, device: str) -> str:
    """Weights drawn from ``seed`` in one call on ``device``, written as
    ``<stem>.npz``; returns its path.  He-normal kernels (``HEAD_GAIN`` over
    the fan-in's root in the head's last convs), BN near identity, class
    biases near ``CLS_BIAS``."""
    shape = leaves(conf)
    sizes = [int(np.prod(s)) for _, s in shape]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for (key, s), x in zip(shape, flat.split(sizes)):
        if key.endswith("_2/kernel"):
            x = x * HEAD_GAIN / (s[0] * s[1] * s[2]) ** 0.5
        elif key.endswith("kernel"):
            x = x * (2.0 / (s[0] * s[1] * s[2])) ** 0.5
        elif key.endswith(("bn/scale", "bn/var")):
            x = 1.0 + 0.1 * x.abs()
        elif "/cls" in key and key.endswith("_2/bias"):
            x = CLS_BIAS + 0.1 * x
        else:
            x = 0.1 * x
        out[key] = x.reshape(s).cpu().numpy()
    path = stem + ".npz"
    np.savez(path, **out)
    return path if os.path.isabs(path) else os.path.abspath(path)
