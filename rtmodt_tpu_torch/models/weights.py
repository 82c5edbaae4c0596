"""Carry the reference package's Flax parameters into the port's YOLOv8.

``load_npz`` reads the reference's flat ``.npz`` checkpoints (keys such as
``params/c2f1/cv1/conv/kernel`` and ``batch_stats/c2f1/cv1/bn/mean``), and
``params_from_jax`` maps such a flat dict - the same one
``flax.traverse_util.flatten_dict(variables, sep="/")`` gives - to a
``state_dict`` for ``models.yolov8.YOLOv8``: conv kernels HWIO -> OIHW, BN
scale/bias -> weight/bias, BN mean/var -> running buffers.  Checkpoints with
BN folded (conv biases, no BN) map to a ``fused=True`` model.  ``save_npz``
writes a model back in that format, for the reference package to read.

Ultralytics checkpoints (``.pt`` / ``.pth``) become the same flat dict
through the port's copy of the reference's converter
(``convert_ultralytics_state_dict``: layer map, OIHW -> HWIO, BN running stats
-> ``batch_stats``); a pickled ``DetectionModel`` loads without the
ultralytics package through a tolerant unpickler.  ``load_params`` picks the
route by file name.  Orbax directories need jax and are refused.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from rtmodt_tpu_torch.utils.logging import logger


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


# -- ultralytics checkpoints --------------------------------------------------

# ultralytics DetectionModel layer index -> the module name here (and in Flax)
_LAYER_MAP = {
    0: "stem", 1: "down1", 2: "c2f1", 3: "down2", 4: "c2f2", 5: "down3",
    6: "c2f3", 7: "down4", 8: "c2f4", 9: "sppf",
    12: "neck_td4", 15: "neck_td3", 16: "neck_dn3", 18: "neck_bu4",
    19: "neck_dn4", 21: "neck_bu5", 22: "head",
}


def _convert_convbn(prefix_out: tuple[str, ...], tp: dict[str, np.ndarray],
                    torch_prefix: str, params: dict, stats: dict) -> None:
    """One Conv+BN block: ``{torch_prefix}.conv.weight`` + ``{torch_prefix}.bn.*``."""
    w = tp[f"{torch_prefix}.conv.weight"]                       # (O, I, kh, kw)
    params[prefix_out + ("conv", "kernel")] = np.transpose(w, (2, 3, 1, 0))
    params[prefix_out + ("bn", "scale")] = tp[f"{torch_prefix}.bn.weight"]
    params[prefix_out + ("bn", "bias")] = tp[f"{torch_prefix}.bn.bias"]
    stats[prefix_out + ("bn", "mean")] = tp[f"{torch_prefix}.bn.running_mean"]
    stats[prefix_out + ("bn", "var")] = tp[f"{torch_prefix}.bn.running_var"]


def _convert_c2f(name: str, tp: dict[str, np.ndarray], torch_prefix: str,
                 params: dict, stats: dict) -> None:
    _convert_convbn((name, "cv1"), tp, f"{torch_prefix}.cv1", params, stats)
    _convert_convbn((name, "cv2"), tp, f"{torch_prefix}.cv2", params, stats)
    i = 0
    while f"{torch_prefix}.m.{i}.cv1.conv.weight" in tp:
        _convert_convbn((name, f"m{i}", "cv1"), tp, f"{torch_prefix}.m.{i}.cv1", params, stats)
        _convert_convbn((name, f"m{i}", "cv2"), tp, f"{torch_prefix}.m.{i}.cv2", params, stats)
        i += 1


class _TrackingDict(dict):
    """Records which checkpoint keys the converter read, so anything left
    over fails loudly instead of vanishing."""

    def __init__(self, d: dict) -> None:
        super().__init__(d)
        self.consumed: set = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)


# Checkpoint tensors deliberately not mapped: torch BN bookkeeping, and the
# DFL "conv", which is the fixed expectation over bins 0..REG_MAX-1 that the
# decode computes in closed form (its value is checked against arange).
_UNMAPPED_OK = re.compile(r"(\.num_batches_tracked$)|(^model\.22\.dfl\.conv\.weight$)")


def convert_ultralytics_state_dict(state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """An ultralytics YOLOv8 float state dict -> the flat Flax variables
    (``params/...`` and ``batch_stats/...`` keys, as ``load_npz`` returns
    them).  Every tensor must be consumed by the mapping or matched by
    ``_UNMAPPED_OK``; anything else raises."""
    params: dict[tuple[str, ...], np.ndarray] = {}
    stats: dict[tuple[str, ...], np.ndarray] = {}
    tp = _TrackingDict(state)

    dfl = state.get("model.22.dfl.conv.weight")
    if dfl is not None:
        bins = np.arange(dfl.size, dtype=np.float32)
        if not np.allclose(np.asarray(dfl).reshape(-1), bins):
            raise ValueError("model.22.dfl.conv.weight is not the fixed arange(REG_MAX) "
                             "expectation; this checkpoint's DFL decode differs from the "
                             "closed form computed here")

    for idx, name in _LAYER_MAP.items():
        if name == "head":
            continue
        pre = f"model.{idx}"
        if f"{pre}.conv.weight" in tp:                        # plain ConvBN
            _convert_convbn((name,), tp, pre, params, stats)
        elif f"{pre}.cv1.conv.weight" in tp and f"{pre}.m.0.cv1.conv.weight" in tp:
            _convert_c2f(name, tp, pre, params, stats)        # C2f
        elif f"{pre}.cv1.conv.weight" in tp:                   # SPPF
            _convert_convbn((name, "cv1"), tp, f"{pre}.cv1", params, stats)
            _convert_convbn((name, "cv2"), tp, f"{pre}.cv2", params, stats)
        else:
            raise KeyError(f"cannot map ultralytics layer model.{idx} -> {name}")

    # Detect head: cv2 = box branch (4*REG_MAX), cv3 = cls branch
    for lvl in range(3):
        for branch, ours in (("cv2", "box"), ("cv3", "cls")):
            for j in range(2):
                _convert_convbn(("head", f"{ours}{lvl}_{j}"), tp,
                                f"model.22.{branch}.{lvl}.{j}", params, stats)
            w = tp[f"model.22.{branch}.{lvl}.2.weight"]
            b = tp[f"model.22.{branch}.{lvl}.2.bias"]
            params[("head", f"{ours}{lvl}_2", "kernel")] = np.transpose(w, (2, 3, 1, 0))
            params[("head", f"{ours}{lvl}_2", "bias")] = b

    leftover = sorted(k for k in state if k not in tp.consumed and not _UNMAPPED_OK.search(k))
    if leftover:
        raise ValueError(f"{len(leftover)} checkpoint tensor(s) not consumed by the "
                         f"ultralytics mapping (first 10: {leftover[:10]}); refusing to "
                         "drop weights silently - extend _LAYER_MAP / _UNMAPPED_OK for "
                         "this architecture variant")
    flat = {"/".join(("params",) + k): v for k, v in params.items()}
    flat.update({"/".join(("batch_stats",) + k): v for k, v in stats.items()})
    return flat


class _StubBase:
    """Stands in for a class the checkpoint pickled but this environment
    cannot import (a real ``yolov8s.pt`` pickles the whole
    ``ultralytics.nn.tasks.DetectionModel``).  Keeps the state the pickle
    hands it, so the module tree stays walkable."""

    def __init__(self, *args, **kwargs):
        self._stub_args = (args, kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_stub_state"] = state

    def __call__(self, *args, **kwargs):
        # some reducers call a pickled instance as the reconstructor
        return self


_STUB_CACHE: dict[tuple[str, str], type] = {}


def _tolerant_torch_load(path: str) -> Any:
    """``torch.load`` that survives unimportable classes in the pickle:
    torch and numpy classes rebuild for real (their tensors with them), any
    other class becomes a stub holding its pickled ``__dict__``."""
    import pickle
    import types

    class _TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                key = (module, name)
                if key not in _STUB_CACHE:
                    logger.debug(f"stubbing unimportable class {module}.{name}")
                    _STUB_CACHE[key] = type(str(name), (_StubBase,),
                                            {"__module__": str(module)})
                return _STUB_CACHE[key]

    shim = types.ModuleType("rtmodt_tolerant_pickle")
    shim.Unpickler = _TolerantUnpickler
    shim.load = pickle.load
    shim.loads = pickle.loads
    return torch.load(path, map_location="cpu", pickle_module=shim, weights_only=False)


def _walk_module_state(obj: Any, prefix: str, out: dict) -> None:
    """``state_dict()`` naming from a (possibly stubbed) module tree: every
    ``nn.Module``, and every stub of one, keeps ``_parameters`` /
    ``_buffers`` / ``_modules`` dicts in its ``__dict__``."""
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for k, v in (d.get("_parameters") or {}).items():
        if v is not None:
            out[prefix + k] = v
    for k, v in (d.get("_buffers") or {}).items():
        if v is not None:
            out[prefix + k] = v
    for k, v in (d.get("_modules") or {}).items():
        if v is not None:
            _walk_module_state(v, f"{prefix}{k}.", out)


def load_ultralytics_pt(path: str) -> dict[str, np.ndarray]:
    """An ultralytics ``.pt`` / ``.pth`` checkpoint -> the flat Flax
    variables.  A plain tensor checkpoint loads with ``weights_only=True``;
    a pickled model unpickles tolerantly, and its state dict comes from the
    module, or from walking the stubbed module tree with torch's dotted
    naming."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        ckpt = _tolerant_torch_load(path)
    model = ckpt if not isinstance(ckpt, dict) else (
        ckpt.get("model") if ckpt.get("model") is not None else ckpt.get("ema", ckpt))
    if isinstance(model, dict):
        sd = model
    elif isinstance(model, torch.nn.Module):
        sd = model.state_dict()
    else:
        sd = {}
        _walk_module_state(model, "", sd)
        if not sd:
            raise TypeError(f"unsupported checkpoint structure in {path}")
    # every tensor goes to the converter, which refuses any it does not map
    state = {k: v.detach().float().numpy() for k, v in sd.items()
             if isinstance(v, torch.Tensor)}
    logger.info(f"converted {len(state)} tensors from {path}")
    return convert_ultralytics_state_dict(state)


def load_params(path: str) -> dict[str, np.ndarray]:
    """The flat Flax variables of a weights file: an ultralytics ``.pt`` /
    ``.pth`` or a reference ``.npz``."""
    if path.endswith((".pt", ".pth")):
        return load_ultralytics_pt(path)
    if path.endswith(".npz"):
        return load_npz(path)
    if os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory, which needs jax; "
                         "write it as .npz with the reference package "
                         "(rtmodt_tpu.models.weights.save_npz)")
    raise ValueError(f"unrecognized weights format: {path}")


def save_npz(model: torch.nn.Module, path: str) -> None:
    """Write ``model``'s weights as a reference ``.npz`` (the inverse of
    ``params_from_jax``: OIHW -> HWIO, BN weight/bias -> ``params/.../bn/
    scale|bias``, running stats -> ``batch_stats/.../bn/mean|var``), float32,
    for ``rtmodt_tpu.models.weights.load_npz`` and the JAX ``Detector``."""
    inverse = {leaf: key for key, leaf in _LEAF.items()}
    sd = model.state_dict()
    if any(name.endswith("qweight") for name in sd):
        raise ValueError("a quantized model cannot be saved as .npz: save the float "
                         "model and quantize on load (detection.quant: int8)")
    flat: dict[str, np.ndarray] = {}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        parts = name.split(".")
        key = inverse.get(".".join(parts[-2:]))
        if key is not None:
            coll, a, b = key
            out = "/".join([coll, *parts[:-2], a, b])
        elif parts[-1] in ("weight", "bias") and t.is_floating_point():
            # a plain conv (the head's final 1x1 convs)
            out = "/".join(["params", *parts[:-1],
                            "kernel" if parts[-1] == "weight" else "bias"])
        else:
            raise ValueError(f"{name} has no place in the reference's format")
        arr = t.detach().float().cpu().numpy()
        if arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 1, 0))                # OIHW -> HWIO
        flat[out] = np.ascontiguousarray(arr)
    np.savez(path, **flat)
