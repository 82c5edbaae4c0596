"""The port's logger: a stdlib logger named ``rtmodt_tpu_torch`` with one
stderr handler (level from ``RTMODT_LOG_LEVEL``, default INFO), exposing the
``logger.info/warning/...`` surface the reference package's modules use."""

from __future__ import annotations

import logging
import os
import sys


def _make_logger() -> logging.Logger:
    log = logging.getLogger("rtmodt_tpu_torch")
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)-8s | %(message)s", "%Y-%m-%d %H:%M:%S"))
        log.addHandler(handler)
        log.setLevel(os.environ.get("RTMODT_LOG_LEVEL", "INFO").upper())
        log.propagate = False
    return log


logger = _make_logger()
