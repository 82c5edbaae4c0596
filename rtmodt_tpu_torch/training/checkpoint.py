"""The port's training checkpoints: one directory per step holding a
``torch.save`` of plain tensors and ints (port of
``rtmodt_tpu/training/checkpoint.py``, whose orbax format is JAX's).

``<dir>/<step>/state.pt`` holds ``{"step", "model" (parameters and BN
buffers), "opt": {"count", "mu", "nu"}, "ema" (or None), "metrics"}``.
Retention is the reference's orbax options: at most ``max_to_keep`` steps,
the best by ``metrics["map50"]`` (a save without metrics counts as 0.0),
ties kept for the later step; a save that ranks below ``max_to_keep``
better ones is dropped at once, as orbax drops it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from rtmodt_tpu_torch.utils.logging import logger

_STATE = "state.pt"
_METRICS = "metrics.json"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._metrics: dict[int, dict[str, float]] = {}
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.isdigit() and os.path.exists(os.path.join(path, _STATE)):
                with open(os.path.join(path, _METRICS)) as f:
                    self._metrics[int(name)] = json.load(f)

    def all_steps(self) -> list[int]:
        return sorted(self._metrics)

    @property
    def latest_step(self) -> int | None:
        return max(self._metrics) if self._metrics else None

    def save(self, step: int, state: dict[str, Any],
             metrics: dict[str, float] | None = None) -> str:
        """Write ``state`` (plain tensors, ints, dicts of them) as step
        ``step``; returns its file.  The tensors are copied to the CPU."""
        path = os.path.join(self.directory, str(step))
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(to_cpu(state), os.path.join(tmp, _STATE))
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        with open(os.path.join(tmp, _METRICS), "w") as f:
            json.dump(metrics, f)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._metrics[step] = metrics
        self._retain()
        logger.info(f"checkpoint saved @ step {step}")
        return os.path.join(path, _STATE)

    def _retain(self) -> None:
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        ranked = sorted(steps, key=lambda s: self._metrics[s].get("map50", 0.0))
        for s in ranked[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)
            del self._metrics[s]

    def restore(self, step: int | None = None,
                device: torch.device | str = "cpu") -> dict[str, Any] | None:
        """The saved state of ``step`` (default the latest), its tensors on
        ``device``; None when there is none."""
        step = self.latest_step if step is None else step
        if step is None:
            return None
        state = torch.load(os.path.join(self.directory, str(step), _STATE),
                           map_location=device, weights_only=True)
        return state

    def close(self) -> None:
        pass


def to_cpu(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x


def train_state_dict(state, ema: dict[str, torch.Tensor] | None) -> dict[str, Any]:
    """The checkpoint of a ``train_step.TrainState`` and its EMA parameters."""
    return {"step": int(state.step), "model": state.model.state_dict(),
            "opt": {"count": int(state.opt_state.count), "mu": dict(state.opt_state.mu),
                    "nu": dict(state.opt_state.nu)},
            "ema": None if ema is None else dict(ema)}


@torch.no_grad()
def load_train_state(state, ckpt: dict[str, Any]) -> dict[str, torch.Tensor] | None:
    """Restore ``ckpt`` into the ``TrainState`` ``state`` in place (tensors
    onto the model's device); returns the EMA parameters (or None)."""
    dev = next(state.model.parameters()).device
    state.model.load_state_dict(ckpt["model"])
    state.step = int(ckpt["step"])
    state.opt_state.count = int(ckpt["opt"]["count"])
    state.opt_state.mu = {k: v.to(dev) for k, v in ckpt["opt"]["mu"].items()}
    state.opt_state.nu = {k: v.to(dev) for k, v in ckpt["opt"]["nu"].items()}
    ema = ckpt.get("ema")
    return None if ema is None else {k: v.to(dev) for k, v in ema.items()}
