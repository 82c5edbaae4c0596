"""BENCHMARK.json against the benchmark's rules: names, units, references,
and which cells report which metrics."""

from __future__ import annotations

import json
import os
import re

import pytest

from perfbench import manifest

M = manifest.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(M) == TOP_KEYS
    assert M["command"] == ["python3", "perfbench/run.py"]
    assert M["paths"] == ["perfbench"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_manifest_has_no_problems():
    assert manifest.problems(M) == []


@pytest.mark.parametrize("name", [x["name"] for k in ("configs", "workloads", "end_to_end",
                                                        "per_layer") for x in M[k]])
def test_names_use_allowed_characters(name):
    assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}", name)


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"], ids=lambda m: m["name"])
def test_units_and_keys(metric):
    assert re.fullmatch(r"[A-Za-z0-9_/%.\-]{1,16}", metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = ({"name", "unit", "better", "bound", "source", "workloads"}
               if "bound" in metric else
               {"name", "unit", "better", "source", "layer", "moves", "workloads"})
    assert set(metric) <= allowed


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_each_of_its_cells_reports(metric):
    e2e = {e["name"]: e for e in M["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert manifest.reports(moved, cell), (metric["name"], cell)
    assert os.path.exists(os.path.join(manifest.ROOT, "perfbench", "metrics",
                                       f"{metric['name']}.py"))


def test_end_to_end_metrics():
    assert {e["name"] for e in M["end_to_end"]} == {"setup_s", "fps", "latency_p95_ms",
                                                     "latency_p50_ms"}
    setup = next(e for e in M["end_to_end"] if e["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for e in M["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(cell):
    c = manifest.load_cell(cell["name"])
    assert c.chips == 1
    assert set(c.limits) >= {"planes_bytes_off", "track_mismatch", "event_mismatch"}
    assert c.config["camera"]["fps"] == 25
    assert c.traffic["loop"] in ("closed", "open")


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_config_file_matches_the_source(conf):
    with open(os.path.join(manifest.ROOT, conf["file"])) as f:
        c = json.load(f)
    # Ultralytics' yolov8.yaml, scale s; nc is the only key changed
    assert (c["depth_multiple"], c["width_multiple"], c["max_channels"]) == (0.33, 0.50, 1024)
    assert conf["reduced"] == ["nc"] and c["nc"] == 8
    assert c["source"] == conf["source"]
