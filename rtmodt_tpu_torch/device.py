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
