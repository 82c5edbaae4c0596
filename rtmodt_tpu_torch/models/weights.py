"""Carry the reference package's Flax parameters into the port's YOLOv8.

``load_npz`` reads the reference's flat ``.npz`` checkpoints (keys such as
``params/c2f1/cv1/conv/kernel`` and ``batch_stats/c2f1/cv1/bn/mean``), and
``params_from_jax`` maps such a flat dict - the same one
``flax.traverse_util.flatten_dict(variables, sep="/")`` gives - to a
``state_dict`` for ``models.yolov8.YOLOv8``: conv kernels HWIO -> OIHW, BN
scale/bias -> weight/bias, BN mean/var -> running buffers.  Checkpoints with
BN folded (conv biases, no BN) map to a ``fused=True`` model.
"""

from __future__ import annotations

import numpy as np
import torch


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Flat ``{key: array}`` of a reference ``.npz`` checkpoint."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def is_fused(flat: dict[str, np.ndarray]) -> bool:
    """True when the checkpoint has BN folded into conv biases."""
    return (any(k.endswith("/conv/bias") for k in flat)
            and not any("/bn/" in k for k in flat))


_LEAF = {
    ("params", "conv", "kernel"): "conv.weight",
    ("params", "conv", "bias"): "conv.bias",
    ("params", "bn", "scale"): "bn.weight",
    ("params", "bn", "bias"): "bn.bias",
    ("batch_stats", "bn", "mean"): "bn.running_mean",
    ("batch_stats", "bn", "var"): "bn.running_var",
}


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat Flax variables -> the port's YOLOv8 ``state_dict`` (float32)."""
    sd: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split("/")
        coll, path = parts[0], parts[1:]
        if coll not in ("params", "batch_stats") or len(path) < 2:
            raise KeyError(f"unexpected checkpoint key {key!r}")
        arr = np.array(value, np.float32)        # a writable copy
        leaf = _LEAF.get((coll, *path[-2:]))
        if leaf is not None:
            name = ".".join(path[:-2] + [leaf])
        elif coll == "params" and path[-1] in ("kernel", "bias"):
            # a plain conv (the head's final 1x1 convs)
            name = ".".join(path[:-1] + ["weight" if path[-1] == "kernel" else "bias"])
        else:
            raise KeyError(f"unexpected checkpoint key {key!r}")
        if name.endswith("weight") and arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))              # HWIO -> OIHW
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def load_into(model: torch.nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Load a flat Flax checkpoint into ``model``; every parameter and BN
    buffer must be present with its shape (``num_batches_tracked`` is not
    part of the reference's checkpoints and keeps its value)."""
    sd = params_from_jax(flat)
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    extra = [k for k in sd if k not in own]
    if missing or extra:
        raise ValueError(f"weight tree mismatch: missing={missing[:5]} extra={extra[:5]} "
                         f"({len(missing)} missing / {len(extra)} extra)")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs {tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=False)


def embedder_params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The 14 flat flax arrays of an appearance-embedder checkpoint
    (``params/<layer>/kernel|bias``) -> the port's ``AppearanceEmbedder``
    ``state_dict`` (float32): conv kernels HWIO -> OIHW, Dense ``(in, out)``
    -> Linear ``(out, in)``."""
    sd: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split("/")
        if len(parts) != 3 or parts[0] != "params" or parts[2] not in ("kernel", "bias"):
            raise KeyError(f"unexpected embedder checkpoint key {key!r}")
        arr = np.array(value, np.float32)
        if parts[2] == "kernel":
            arr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr.T
        sd[f"{parts[1]}.{'weight' if parts[2] == 'kernel' else 'bias'}"] = \
            torch.from_numpy(np.ascontiguousarray(arr))
    return sd
