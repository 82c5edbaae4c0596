"""The port's logger: a loguru-style facade over the stdlib ``logging``.

The surface the reference package's modules and tools use:
``logger.debug/info/warning/error/critical/success/exception`` with
``str.format`` arguments (a malformed spec logs the message as it is and
never raises), ``logger.add(sink, level=..., rotation=...) -> id`` and
``logger.remove(id=None)``, and ``configure_from_yaml(path)`` for the
console, file and jsonl sinks of ``config/logging.yaml``.

A sink with ``write`` (``sys.stderr``, a ``StringIO``) logs coloured lines
when it is a tty or when ``colorize=True``; a path logs to a file, rotated
at ``rotation`` bytes (``"50 MB"``, ``"512KB"``, an int) with five backups.
Every sink writes ``%Y-%m-%d %H:%M:%S | LEVEL    | message``.  The records
go through the stdlib logger ``rtmodt_tpu_torch`` at level DEBUG; each sink
is a handler at its own level.  At import one stderr sink logs at
``RTMODT_LOG_LEVEL`` (default INFO).
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import re
import sys
from typing import Any

_LEVEL_COLORS = {
    "DEBUG": "\x1b[36m",
    "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m",
    "CRITICAL": "\x1b[35m",
}
_RESET = "\x1b[0m"
ROTATION_BACKUPS = 5

_SIZE_RE = re.compile(r"^\s*([\d.]+)\s*(KB|MB|GB|B)?\s*$", re.IGNORECASE)


def _parse_rotation(rotation: str | int | None) -> int:
    """A rotation size such as ``"50 MB"`` in bytes; 0 (no rotation) for
    None or anything that does not parse."""
    if rotation is None:
        return 0
    if isinstance(rotation, (int, float)):
        return int(rotation)
    m = _SIZE_RE.match(str(rotation))
    if not m:
        return 0
    unit = (m.group(2) or "B").upper()
    return int(float(m.group(1)) * {"B": 1, "KB": 1024, "MB": 1024**2, "GB": 1024**3}[unit])


class _LineFormatter(logging.Formatter):
    def __init__(self, use_color: bool = True) -> None:
        super().__init__()
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        ts = self.formatTime(record, "%Y-%m-%d %H:%M:%S")
        level = record.levelname
        msg = record.getMessage()
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        if self.use_color:
            return f"{ts} | {_LEVEL_COLORS.get(level, '')}{level:<8}{_RESET} | {msg}"
        return f"{ts} | {level:<8} | {msg}"


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        return json.dumps({"time": self.formatTime(record), "level": record.levelname,
                           "message": record.getMessage()})


class _Logger:
    """The loguru-style logger singleton."""

    def __init__(self) -> None:
        self._logger = logging.getLogger("rtmodt_tpu_torch")
        self._logger.setLevel(logging.DEBUG)
        self._logger.propagate = False
        self._handler_ids: dict[int, logging.Handler] = {}
        self._next_id = 0
        self.add(sys.stderr, level=os.environ.get("RTMODT_LOG_LEVEL", "INFO"))

    def add(
        self,
        sink: Any,
        level: str = "DEBUG",
        rotation: str | int | None = None,
        retention: Any = None,       # accepted as loguru takes it; unused
        compression: Any = None,     # accepted as loguru takes it; unused
        serialize: bool = False,     # accepted as loguru takes it; unused
        colorize: bool | None = None,
        format: str | None = None,   # noqa: A002 - loguru's name; unused
        **_: Any,
    ) -> int:
        """Add a sink (a stream or a file path) at ``level``; returns its
        id for ``remove``."""
        handler: logging.Handler
        if hasattr(sink, "write"):
            handler = logging.StreamHandler(sink)
            use_color = (colorize if colorize is not None
                         else getattr(sink, "isatty", lambda: False)())
            handler.setFormatter(_LineFormatter(use_color=use_color))
        else:
            path = str(sink)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            max_bytes = _parse_rotation(rotation)
            if max_bytes > 0:
                handler = logging.handlers.RotatingFileHandler(
                    path, maxBytes=max_bytes, backupCount=ROTATION_BACKUPS)
            else:
                handler = logging.FileHandler(path)
            handler.setFormatter(_LineFormatter(use_color=False))
        handler.setLevel(getattr(logging, str(level).upper(), logging.DEBUG))
        self._logger.addHandler(handler)
        hid = self._next_id
        self._next_id += 1
        self._handler_ids[hid] = handler
        return hid

    def remove(self, handler_id: int | None = None) -> None:
        """Remove the sink ``handler_id``, or every sink (None)."""
        ids = list(self._handler_ids) if handler_id is None else [handler_id]
        for hid in ids:
            handler = self._handler_ids.pop(hid, None)
            if handler is not None:
                self._logger.removeHandler(handler)
                handler.close()

    def _log(self, level: int, message: Any, *args: Any, **kwargs: Any) -> None:
        if args or kwargs:
            try:
                message = str(message).format(*args, **kwargs)
            except (IndexError, KeyError, ValueError):
                pass     # a malformed format spec never fails the call site
        self._logger.log(level, message)

    def debug(self, message: Any, *a: Any, **k: Any) -> None:
        self._log(logging.DEBUG, message, *a, **k)

    def info(self, message: Any, *a: Any, **k: Any) -> None:
        self._log(logging.INFO, message, *a, **k)

    def success(self, message: Any, *a: Any, **k: Any) -> None:
        self._log(logging.INFO, message, *a, **k)

    def warning(self, message: Any, *a: Any, **k: Any) -> None:
        self._log(logging.WARNING, message, *a, **k)

    def error(self, message: Any, *a: Any, **k: Any) -> None:
        self._log(logging.ERROR, message, *a, **k)

    def critical(self, message: Any, *a: Any, **k: Any) -> None:
        self._log(logging.CRITICAL, message, *a, **k)

    def exception(self, message: Any, *a: Any, **k: Any) -> None:
        """ERROR with the traceback of the exception being handled."""
        self._logger.log(logging.ERROR, str(message), exc_info=True)


logger = _Logger()


def configure_from_yaml(path: str) -> None:
    """Replace every sink by those of a ``config/logging.yaml``-style file:
    ``console`` (stderr), ``file`` (rotated at ``rotation``) and ``jsonl``
    (one JSON object a line with ``time``, ``level`` and ``message``), each
    with ``enabled`` and ``level``."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    logger.remove()
    con = cfg.get("console", {})
    if con.get("enabled", True):
        logger.add(sys.stderr, level=con.get("level", "INFO"), colorize=con.get("colorize"))
    fl = cfg.get("file", {})
    if fl.get("enabled"):
        logger.add(fl.get("path", "logs/rtmodt.log"), level=fl.get("level", "DEBUG"),
                   rotation=fl.get("rotation"))
    js = cfg.get("jsonl", {})
    if js.get("enabled"):
        hid = logger.add(js.get("path", "logs/rtmodt.jsonl"), level=js.get("level", "INFO"))
        logger._handler_ids[hid].setFormatter(_JsonFormatter())
