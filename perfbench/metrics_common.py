"""Helpers of the per-layer metric readers."""

from __future__ import annotations

import os
from typing import Any, Callable


def load_reader(name: str) -> Callable[[Any], float | None]:
    """The ``read`` of ``perfbench/metrics/<name>.py`` of this checkout."""
    from perfbench import manifest

    return manifest.metric_reader(name, os.path.dirname(os.path.dirname(__file__)))
