"""Device selection for the port's entry points.

Entry points default to ``"cuda"``.  Asked for CUDA where there is none they
raise: the port never carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda | cpu)")
    return dev


def config_device(system_device: str) -> str:
    """The device a config's ``system.device`` names: ``cpu`` is the CPU;
    ``cuda`` and ``tpu`` (the reference YAML's default, so that it loads
    unmodified) are the card.  Anything else raises."""
    name = str(system_device).lower()
    if name not in ("tpu", "cuda", "cpu"):
        raise ValueError(f"system.device must be cuda|cpu (tpu also means the card), "
                         f"got {system_device!r}")
    return "cpu" if name == "cpu" else "cuda"
