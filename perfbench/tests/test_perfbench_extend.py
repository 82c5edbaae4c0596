"""A later change adds a configuration, a traffic mix, a cell and a per-layer
metric as new files and manifest entries; the harness finds them by name,
and no file it already had changes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from perfbench import manifest


def _digests(root: str) -> dict[str, str]:
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "perfbench")):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_config_traffic_and_metric_are_found(tmp_path):
    root = str(tmp_path / "root")
    shutil.copytree(os.path.join(manifest.ROOT, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest.load_manifest()
    before = _digests(root)

    bench = os.path.join(root, "perfbench")
    with open(os.path.join(manifest.ROOT, m["configs"][0]["file"])) as f:
        conf = json.load(f)
    conf["pipeline"]["detection"]["nms_candidates"] = 2048
    with open(os.path.join(bench, "configs", "yolov8s-640-wide.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(bench, "workloads", "streams8.json"), "w") as f:
        json.dump({"scene": "moving_boxes", "objects": 8, "streams": 8, "chunk": 16,
                   "depth": 2, "loop": "closed", "pool_frames": 32}, f)
    with open(os.path.join(bench, "limits", "yolov8s-640-wide.streams8.json"), "w") as f:
        json.dump({"planes_bytes_off": 0, "track_mismatch": 0, "event_mismatch": 0}, f)
    with open(os.path.join(bench, "metrics", "k1_share.py"), "w") as f:
        f.write("def read(run):\n    return 42.0\n")
    m["configs"].append({"name": "yolov8s-640-wide", "source": m["configs"][0]["source"],
                         "file": "perfbench/configs/yolov8s-640-wide.json", "reduced": ["nc"],
                         "why": "K1's wide path"})
    m["workloads"].append({"name": "yolov8s-640-wide.streams8", "config": "yolov8s-640-wide",
                           "traffic": "streams8", "chips": 1, "why": "eight streams"})
    next(e for e in m["end_to_end"] if e["name"] == "fps")["workloads"].append(
        "yolov8s-640-wide.streams8")
    m["per_layer"].append({"name": "k1_share", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "device", "moves": "fps",
                           "workloads": ["yolov8s-640-wide.streams8"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)

    assert manifest.problems(m, root) == []
    cell = manifest.load_cell("yolov8s-640-wide.streams8", root)
    assert cell.config["pipeline"]["detection"]["nms_candidates"] == 2048
    assert cell.traffic["streams"] == 8
    assert [p["name"] for p in cell.per_layer] == ["k1_share"]
    assert manifest.metric_reader("k1_share", root)(None) == 42.0
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())


def test_live_readers_are_the_closed_cells_readers():
    class Run:
        def ms_per_frame(self, *names):
            return float(len(names))

        trace = {"busy_s": 1.0, "window_s": 4.0}

    for name in ("pack_ms_per_frame", "submit_ms_per_frame", "events_ms_per_frame",
                 "device_idle_pct"):
        assert (manifest.metric_reader(f"{name}.live")(Run())
                == manifest.metric_reader(name)(Run()))
