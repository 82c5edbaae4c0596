"""The port's logger (``rtmodt_tpu_torch/utils/logging.py``) against the JAX
package's (``rtmodt_tpu/utils/logging.py``) on the same calls.

  * ``_parse_rotation`` gives the reference's bytes for every unit, None and
    junk.
  * The same calls into file sinks at INFO (``{}`` arguments, a malformed
    spec, ``success``, a filtered ``debug``, ``exception`` with its
    traceback) write the same lines once the timestamps are stripped.
  * A ``"2 KB"`` rotating sink fed 200 fixed-length lines leaves the same
    file names and sizes.
  * ``configure_from_yaml`` (console off, file and jsonl on) writes the same
    records and JSON keys; the packaged ``config/logging.yaml`` sets up its
    sinks in both packages alike.
  * A ``StringIO`` sink with ``colorize=True`` gets the same bytes.
  * The CLI's ``setup_sinks`` leaves stderr at the config's level and a
    50 MiB ``RotatingFileHandler`` with five backups on
    ``<log_dir>/pipeline.log``.

Each test takes both singletons' sinks away first and puts them back after.
"""

from __future__ import annotations

import io
import json
import logging
import logging.handlers
import os
import sys

import pytest
import yaml

import rtmodt_tpu.utils.logging as jax_logging
import rtmodt_tpu_torch.utils.logging as port_logging
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS = len("2026-01-01 00:00:00")
LOGGERS = {"jax": jax_logging.logger, "port": port_logging.logger}


@pytest.fixture(autouse=True)
def bare_sinks():
    """Both loggers with no sink while the test runs; their sinks back after."""
    saved = {name: dict(lg._handler_ids) for name, lg in LOGGERS.items()}
    for lg in LOGGERS.values():
        for h in lg._handler_ids.values():
            lg._logger.removeHandler(h)
        lg._handler_ids.clear()
    yield
    for name, lg in LOGGERS.items():
        lg.remove()
        for hid, h in saved[name].items():
            lg._handler_ids[hid] = h
            lg._logger.addHandler(h)


def _emit(log) -> None:
    """The same calls on either logger (one function, so that the
    tracebacks name the same lines)."""
    log.info("plain message")
    log.info("{} objects in zone {}", 3, "gate")
    log.info("{name} at {fps:.1f} fps", name="cam0", fps=29.97)
    log.warning("a malformed spec { stays as it is", 1)
    log.error("an index past the arguments {1}", "only one")
    log.success("warmup done")
    log.debug("filtered out at INFO {}", 1)
    log.critical("card lost")
    try:
        raise RuntimeError("the stream died")
    except RuntimeError:
        log.exception("ingest failed")
    log.info("after the traceback")


def _stripped(path) -> list[str]:
    with open(path) as f:
        lines = f.read().splitlines()
    return [line[TS:] if line[:4].isdigit() else line for line in lines]


@pytest.mark.parametrize("spec", ["10 MB", "512KB", "1.5 GB", 2048, None, "junk"])
def test_parse_rotation_matches_the_reference(spec):
    assert port_logging._parse_rotation(spec) == jax_logging._parse_rotation(spec)


def test_public_surface_matches_the_reference():
    def public(obj):
        return {n for n in dir(obj) if not n.startswith("_")}

    assert public(port_logging.logger) == public(jax_logging.logger)
    assert callable(port_logging.configure_from_yaml)
    stdlib = logging.getLogger("rtmodt_tpu_torch")
    assert port_logging.logger._logger is stdlib
    assert stdlib.level == logging.DEBUG and not stdlib.propagate


def test_file_sinks_write_the_same_lines(tmp_path):
    got = {}
    for name, lg in LOGGERS.items():
        path = tmp_path / f"{name}.log"
        hid = lg.add(str(path), level="INFO")
        _emit(lg)
        lg.remove(hid)
        got[name] = _stripped(path)
    assert got["port"] == got["jax"]
    lines = got["port"]
    assert " | INFO     | 3 objects in zone gate" in lines
    assert " | INFO     | cam0 at 30.0 fps" in lines
    assert " | WARNING  | a malformed spec { stays as it is" in lines
    assert " | INFO     | warmup done" in lines
    assert not any("filtered out" in line for line in lines)
    assert "RuntimeError: the stream died" in lines
    assert lines[-1] == " | INFO     | after the traceback"


def test_rotation_leaves_the_same_files(tmp_path):
    listing = {}
    for name, lg in LOGGERS.items():
        d = tmp_path / name
        hid = lg.add(str(d / "rot.log"), level="DEBUG", rotation="2 KB")
        assert isinstance(lg._handler_ids[hid], logging.handlers.RotatingFileHandler)
        for i in range(200):
            lg.info("line {:04d} {}", i, "x" * 20)
        lg.remove(hid)
        listing[name] = sorted((f, os.path.getsize(d / f)) for f in os.listdir(d))
    assert listing["port"] == listing["jax"]
    assert [f for f, _ in listing["port"]] == ["rot.log"] + [f"rot.log.{i}" for i in range(1, 6)]
    assert all(size <= 2048 for _, size in listing["port"])


def test_configure_from_yaml_writes_the_same_records(tmp_path):
    got = {}
    for name, lg in LOGGERS.items():
        mod = jax_logging if name == "jax" else port_logging
        spec = {"console": {"enabled": False},
                "file": {"enabled": True, "path": str(tmp_path / name / "f.log"),
                         "level": "DEBUG", "rotation": "1 MB"},
                "jsonl": {"enabled": True, "path": str(tmp_path / name / "j.jsonl"),
                          "level": "WARNING"}}
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump(spec))
        mod.configure_from_yaml(str(cfg))
        assert len(lg._handler_ids) == 2
        lg.debug("debug {}", 1)
        lg.info("info")
        lg.warning("warning {}", "w")
        lg.error("error")
        lg.remove()
        with open(tmp_path / name / "j.jsonl") as f:
            records = [json.loads(line) for line in f]
        got[name] = (_stripped(tmp_path / name / "f.log"),
                     [sorted(r) for r in records],
                     [(r["level"], r["message"]) for r in records])
    assert got["port"] == got["jax"]
    assert got["port"][1] == [["level", "message", "time"]] * 2
    assert got["port"][2] == [("WARNING", "warning w"), ("ERROR", "error")]
    assert len(got["port"][0]) == 4


def test_packaged_logging_yaml_sets_up_the_same_sinks(tmp_path, monkeypatch):
    """The port's ``config/logging.yaml`` and the reference's, each through
    its own package: a coloured INFO console and a 10 MB DEBUG file under
    ``logs/`` (relative to the working directory)."""
    got = {}
    for name, lg in LOGGERS.items():
        mod = jax_logging if name == "jax" else port_logging
        pkg = "rtmodt_tpu" if name == "jax" else "rtmodt_tpu_torch"
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        mod.configure_from_yaml(os.path.join(ROOT, pkg, "config", "logging.yaml"))
        handlers = list(lg._handler_ids.values())
        got[name] = [(type(h).__name__, h.level, getattr(h, "maxBytes", None),
                      getattr(h, "backupCount", None),
                      os.path.relpath(h.baseFilename) if hasattr(h, "baseFilename") else None,
                      getattr(h.formatter, "use_color", None))
                     for h in handlers]
        lg.info("to the file")
        lg.remove()
        assert "to the file" in (tmp_path / name / "logs" / "rtmodt.log").read_text()
    assert got["port"] == got["jax"]
    assert got["port"] == [
        ("StreamHandler", logging.INFO, None, None, None, True),
        ("RotatingFileHandler", logging.DEBUG, 10 * 1024**2, 5,
         os.path.join("logs", "rtmodt.log"), False)]


def test_colorized_stream_gets_the_same_bytes():
    got = {}
    for name, lg in LOGGERS.items():
        buf = io.StringIO()
        hid = lg.add(buf, level="DEBUG", colorize=True)
        lg.debug("d {}", 1)
        lg.info("i")
        lg.warning("w")
        lg.error("e")
        lg.critical("c")
        lg.remove(hid)
        got[name] = [line[TS:] for line in buf.getvalue().splitlines()]
    assert got["port"] == got["jax"]
    assert got["port"][1] == " | \x1b[32mINFO    \x1b[0m | i"


def test_plain_stream_is_not_coloured():
    buf = io.StringIO()
    hid = port_logging.logger.add(buf, level="INFO")
    port_logging.logger.info("x {}", 1)
    port_logging.logger.remove(hid)
    assert buf.getvalue()[TS:] == " | INFO     | x 1\n"


def test_cli_sinks_rotate_pipeline_log(tmp_path):
    from tools.run_pipeline_torch import setup_sinks

    log_dir = tmp_path / "logs"
    setup_sinks("WARNING", str(log_dir))
    handlers = list(port_logging.logger._handler_ids.values())
    assert len(handlers) == 2
    console, file = handlers
    assert type(console) is logging.StreamHandler and console.stream is sys.stderr
    assert console.level == logging.WARNING
    assert isinstance(file, logging.handlers.RotatingFileHandler)
    assert file.baseFilename == str(log_dir / "pipeline.log")
    assert (file.maxBytes, file.backupCount, file.level) == (50 * 1024**2, 5, logging.DEBUG)
    port_logging.logger.debug("debug line {}", 7)
    port_logging.logger.remove()
    assert (log_dir / "pipeline.log").read_text()[TS:] == " | DEBUG    | debug line 7\n"
