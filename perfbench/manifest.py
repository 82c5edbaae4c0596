"""The benchmark's manifest (``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by name:

  * a configuration: ``perfbench/configs/<config>.json`` (the manifest's
    ``file``);
  * a traffic mix: ``perfbench/workloads/<traffic>.json``;
  * a per-layer metric's reader: ``perfbench/metrics/<metric name>.py``,
    a module with ``read(run) -> float | None``;
  * a cell's correctness limits: ``perfbench/limits/<cell name>.json``;
  * a configuration's architecture: ``perfbench/archs/<arch>.py`` (the
    configuration's ``arch``, ``yolov8`` where it has none), a module with
    ``forward_flops(conf) -> float``, ``load_reference(conf, weights_path,
    device)``, ``detect(model, x, det) -> {boxes, scores, classes, valid}``
    in model-input pixels and ``SUPPRESSED: bool`` (greedy suppression is
    the detector's guarantee); optionally ``seeded_weights(conf, seed, stem,
    device) -> path`` (for ``"weights": {"seed": n}``), ``control_config(cell)``
    and ``control_detector(pipe, pool)``.

A later change adds a cell, a configuration, a traffic mix or a metric by
adding such files and manifest entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Any, Callable

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
DEFAULT_ARCH = "yolov8"


def load_manifest(root: str = ROOT) -> dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of the manifest with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict[str, Any]
    traffic: dict[str, Any]
    limits: dict[str, float]
    end_to_end: list[dict[str, Any]]
    per_layer: list[dict[str, Any]]


def reports(metric: dict[str, Any], cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (every cell, without a
    ``workloads`` key)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    m = load_manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    confs = {c["name"]: c for c in m["configs"]}
    bench = os.path.join(root, "perfbench")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], traffic_name=w["traffic"],
        config=_json(os.path.join(root, confs[w["config"]]["file"])),
        traffic=_json(os.path.join(bench, "workloads", f"{w['traffic']}.json")),
        limits=_json(os.path.join(bench, "limits", f"{name}.json")),
        end_to_end=[e for e in m["end_to_end"] if reports(e, name)],
        per_layer=[p for p in m["per_layer"] if reports(p, name)])


def _load_file(path: str, module_name: str) -> Any:
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT) -> Callable[[Any], float | None]:
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    return _load_file(path, f"perfbench_metric_{name.replace('.', '_')}").read


def arch_name(conf: dict[str, Any]) -> str:
    return conf.get("arch", DEFAULT_ARCH)


def arch_module(conf: dict[str, Any], root: str = ROOT) -> Any:
    """The architecture module ``perfbench/archs/<arch>.py`` of a
    configuration file's contents."""
    name = arch_name(conf)
    if not NAME_RE.match(name):
        raise ValueError(f"bad arch name {name!r}")
    path = os.path.join(root, "perfbench", "archs", f"{name}.py")
    return _load_file(path, f"perfbench_arch_{name.replace('.', '_').replace('-', '_')}")


def problems(m: dict[str, Any], root: str = ROOT) -> list[str]:
    """What in the manifest breaks the benchmark's rules on names, units and
    references (empty when none)."""
    out = []
    names = ([c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
             + [e["name"] for e in m["end_to_end"] + m["per_layer"]])
    for n in names + [w["traffic"] for w in m["workloads"]] + [w["config"] for w in
                                                                m["workloads"]]:
        if not NAME_RE.match(n):
            out.append(f"bad name {n!r}")
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in m[group]]
        if len(seen) != len(set(seen)):
            out.append(f"duplicate name in {group}")
    metric_names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    if len(metric_names) != len(set(metric_names)):
        out.append("duplicate metric name")
    for e in m["end_to_end"] + m["per_layer"]:
        if not UNIT_RE.match(e["unit"]):
            out.append(f"bad unit {e['unit']!r} of {e['name']}")
        if e["better"] not in ("lower", "higher"):
            out.append(f"bad 'better' of {e['name']}")
        if e["source"] not in SOURCES:
            out.append(f"bad source of {e['name']}")
    for c in m["configs"]:
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                out.append(f"bad reduced key {k!r}")
        if not os.path.exists(os.path.join(root, c["file"])):
            out.append(f"missing config file {c['file']}")
            continue
        arch = arch_name(_json(os.path.join(root, c["file"])))
        if not (NAME_RE.match(arch)
                and os.path.exists(os.path.join(root, "perfbench", "archs", f"{arch}.py"))):
            out.append(f"no architecture module perfbench/archs/{arch}.py for {c['name']}")
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = [w["name"] for w in m["workloads"]]
    for p in m["per_layer"]:
        if p["moves"] not in e2e:
            out.append(f"{p['name']} moves unknown metric {p['moves']!r}")
            continue
        for cell in cells:
            if reports(p, cell) and not reports(e2e[p["moves"]], cell):
                out.append(f"{cell} reports {p['name']} but not {p['moves']}")
        if not os.path.exists(os.path.join(root, "perfbench", "metrics", f"{p['name']}.py")):
            out.append(f"no reader perfbench/metrics/{p['name']}.py")
    for w in m["workloads"]:
        for path in (os.path.join(root, "perfbench", "workloads", f"{w['traffic']}.json"),
                     os.path.join(root, "perfbench", "limits", f"{w['name']}.json")):
            if not os.path.exists(path):
                out.append(f"missing {os.path.relpath(path, root)}")
        reported = [e for e in m["end_to_end"] if reports(e, w["name"])]
        if not any(e["name"] == "setup_s" for e in reported) or len(reported) < 2:
            out.append(f"{w['name']} must report setup_s and another end-to-end metric")
        if not any(reports(p, w["name"]) for p in m["per_layer"]):
            out.append(f"{w['name']} reports no per-layer metric")
    return out
