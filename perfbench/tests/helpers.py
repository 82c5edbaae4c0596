"""A copy of the benchmark in a temporary root, with a cell small enough
for the CPU: YOLOv8s at 256 input on 288 x 512 cameras (native 2x pack),
float32 compute, two streams, zones scaled to the frame."""

from __future__ import annotations

import json
import os
import shutil

from perfbench import manifest

WEIGHTS = os.path.join(manifest.ROOT, "checkpoints", "rich640d", "ema_final.npz")


def tiny_root(tmp: str, loop: str = "closed", streams: int = 2) -> str:
    """A root holding BENCHMARK.json and perfbench/ with the cell ``tiny``."""
    root = os.path.join(tmp, "root")
    shutil.copytree(os.path.join(manifest.ROOT, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest.load_manifest()
    with open(os.path.join(manifest.ROOT, m["configs"][0]["file"])) as f:
        conf = json.load(f)
    conf["weights"] = WEIGHTS
    conf["imgsz"] = 256
    conf["camera"] = {"height": 288, "width": 512, "fps": 25}
    conf["pipeline"]["detection"].update(input_size=256, half=False)
    conf["pipeline"]["events"]["zones"] = [
        {"name": "left", "polygon": [[10, 10], [250, 10], [250, 280], [10, 280]],
         "trigger": "intrusion", "dwell_time_sec": 0.2, "cooldown_sec": 0.4, "direction": None,
         "classes": None},
        {"name": "gate", "polygon": [[200, 0], [500, 0], [500, 288], [200, 288]],
         "trigger": "crossing", "direction": "left_to_right", "dwell_time_sec": 2.0,
         "cooldown_sec": 0.4, "classes": None}]
    with open(os.path.join(root, "perfbench", "configs", "tiny.json"), "w") as f:
        json.dump(conf, f)
    traffic = {"scene": "moving_boxes", "objects": 6, "streams": streams, "chunk": 2,
               "depth": 1, "loop": loop, "pool_frames": 4, "check_streams": streams,
               "trace_chunks": 2}
    with open(os.path.join(root, "perfbench", "workloads", "tiny.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "perfbench", "limits",
                           f"{m['workloads'][0]['name']}.json")) as f:
        limits = json.load(f)
    with open(os.path.join(root, "perfbench", "limits", "tiny.json"), "w") as f:
        json.dump(limits, f)
    m["configs"].append({"name": "tiny", "source": m["configs"][0]["source"],
                         "file": "perfbench/configs/tiny.json", "reduced": ["nc", "imgsz"],
                         "why": "a CPU-sized cell for the harness's tests"})
    m["workloads"].append({"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1,
                           "why": "two small streams on the CPU"})
    key = "fps" if loop == "closed" else "latency_p95_ms"
    for e in m["end_to_end"] + m["per_layer"]:
        moves = e.get("moves", e["name"])
        if "workloads" in e and (moves == key or (loop == "open" and moves == "latency_p95_ms")
                                 or e["name"] in (key, "latency_p50_ms" if loop == "open"
                                                  else key)):
            e["workloads"].append("tiny")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return root
