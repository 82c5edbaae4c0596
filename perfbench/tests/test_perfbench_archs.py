"""Architectures as files (``perfbench/archs/<arch>.py``), the program's spans
and counters in ``RunRecord``, and the trace's kernel table:

  (a) a made-up architecture added through new files and manifest entries
      only runs whole on the CPU with its own operation count, reference,
      seeded weights and suppression flag, and no file of the harness
      changes;
  (b) the ``yolov8`` module gives today's operation counts and, on one
      run's record, the same check numbers as the direct calls of the plain
      reference;
  (c) the program's spans and counters reach ``RunRecord`` and the two
      readers with ``--trace 1``, and ``--trace 0`` never turns the
      recorder on;
  (d) ``devtrace.reduce``'s ``kernel_table`` on ``fixtures/trace_small.json``."""

from __future__ import annotations

import hashlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import bench, check, devtrace, manifest
from perfbench.peaks import BF16_FLOPS
from perfbench.reference import yolo
from perfbench.tests.helpers import WEIGHTS, tiny_root
from rtmodt_tpu_torch.profiling import spans

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "trace_small.json")
MARKER_FLOPS = 1.25e9
WEIGHTS_SEED = 424242

FAKE = '''"""A made-up architecture: YOLOv8 underneath, its own operation count,
no suppression guarantee, seeded weights; logs its calls."""

import json
import os

from perfbench import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_yolo = manifest.arch_module({}, ROOT)
SUPPRESSED = False


def _log(*entry):
    with open(os.environ["PERFBENCH_FAKE_ARCH_LOG"], "a") as f:
        f.write(json.dumps(entry) + "\\n")


def forward_flops(conf):
    return %r


def seeded_weights(conf, seed, stem, device):
    path = _yolo.seeded_weights(conf, seed, stem, device)
    _log("weights", seed, path)
    return path


def load_reference(conf, weights_path, device):
    _log("reference", weights_path)
    return _yolo.load_reference(conf, weights_path, device)


def detect(model, x, det):
    _log("detect", int(x.shape[0]))
    return _yolo.detect(model, x, det)
''' % MARKER_FLOPS


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _digests(root: str) -> dict[str, str]:
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "perfbench")):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _run(root, workload, trace, hooks=None, seconds="2"):
    args = bench.parse_args(["--workload", workload, "--seed", "3000000013", "--seconds",
                             seconds, "--trace", str(trace)])
    return bench.run(args, time.perf_counter(), root, device="cpu", hooks=hooks)


def _add_fake(root: str) -> None:
    """The fake architecture's files and manifest entries, beside ``tiny``'s."""
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "archs", "fake.py"), "w") as f:
        f.write(FAKE)
    with open(os.path.join(pb, "configs", "tiny.json")) as f:
        conf = json.load(f)
    conf.update(arch="fake", weights={"seed": WEIGHTS_SEED})
    with open(os.path.join(pb, "configs", "fake.json"), "w") as f:
        json.dump(conf, f)
    with open(os.path.join(pb, "limits", "tiny.json")) as f:
        limits = json.load(f)
    del limits["det_overlap_pairs"]
    with open(os.path.join(pb, "limits", "fake.tiny.json"), "w") as f:
        json.dump(limits, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["configs"].append({"name": "fake", "source": "https://example.org/fake",
                         "file": "perfbench/configs/fake.json", "reduced": [],
                         "why": "a made-up architecture"})
    m["workloads"].append({"name": "fake.tiny", "config": "fake", "traffic": "tiny",
                           "chips": 1, "why": "the made-up architecture on two small streams"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "tiny" in e.get("workloads", ()):
            e["workloads"].append("fake.tiny")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)


def test_an_architecture_from_new_files_only(tmp_path, monkeypatch):
    root = tiny_root(str(tmp_path))
    before = _digests(root)
    _add_fake(root)
    log = tmp_path / "fake.log"
    monkeypatch.setenv("PERFBENCH_FAKE_ARCH_LOG", str(log))
    assert manifest.problems(manifest.load_manifest(root), root) == []
    seen = {}

    def program(pipe, pool):
        seen["program_weights"] = pipe.cfg.detection.weights
        seen["exists"] = os.path.exists(pipe.cfg.detection.weights)

    res = _run(root, "fake.tiny", 1, {"pipeline": program, "run": lambda rr: seen.update(rr=rr)},
               seconds="3")
    assert res["correct"], res["checks"]
    assert "det_overlap_pairs" not in res["checks"]
    assert set(res["checks"]) == set(check.ORDER) - {"det_overlap_pairs"}
    rr = seen["rr"]
    assert rr.flops_per_frame == MARKER_FLOPS
    assert res["metrics"]["mfu"]["value"] == pytest.approx(
        100.0 * MARKER_FLOPS * rr.frames_per_s() / BF16_FLOPS, rel=1e-12)
    calls = [json.loads(x) for x in log.read_text().splitlines()]
    made = [c for c in calls if c[0] == "weights"]
    assert len(made) == 1 and made[0][1] == WEIGHTS_SEED
    path = made[0][2]
    assert seen["program_weights"] == path and seen["exists"]
    assert [c[1] for c in calls if c[0] == "reference"] == [path]
    assert sum(c[1] for c in calls if c[0] == "detect") == 2 * 4     # streams x pool frames
    assert not os.path.exists(path)                                  # the run's tmp is gone
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("name,flops", [("yolov8s-640", 28_447_795_200),
                                        ("yolov8s-1280", 113_791_180_800)])
def test_yolov8_module_counts_today_s_operations(name, flops):
    conf = manifest.load_cell(next(w["name"] for w in manifest.load_manifest()["workloads"]
                                   if w["config"] == name)).config
    arch = manifest.arch_module(conf)
    assert "arch" not in conf and arch.SUPPRESSED
    assert arch.forward_flops(conf) == flops
    with np.load(os.path.join(manifest.ROOT, conf["weights"])) as z:
        assert dict(arch.leaves(conf)) == {k: z[k].shape for k in z.files}


@pytest.fixture(scope="module")
def trace0(tmp_path_factory):
    """One ``--trace 0`` run of ``tiny``: the recorder watched at every hook,
    its ``enable`` counted, the record, pool and numbers kept."""
    root = tiny_root(str(tmp_path_factory.mktemp("perfbench")))
    seen = {"enabled": [], "enable_calls": 0}
    enable = spans.enable

    def counted():
        seen["enable_calls"] += 1
        enable()

    def watch(name):
        def hook(*a):
            seen["enabled"].append(spans.enabled())
            seen[name] = a
        return hook

    spans.enable = counted
    try:
        seen["result"] = _run(root, "tiny", 0, {k: watch(k) for k in
                                                ("cell", "pipeline", "run", "record", "numbers")})
    finally:
        spans.enable = enable
    seen["enabled"].append(spans.enabled())
    return seen


def test_yolov8_module_gives_the_direct_calls_numbers(trace0):
    (rec, conf), (pipe, pool), (numbers,) = trace0["record"], trace0["pipeline"], trace0["numbers"]
    direct = SimpleNamespace(load_reference=lambda c, w, d: yolo.PlainYOLOv8(w, d),
                             detect=yolo.detect, SUPPRESSED=True)
    want = check.run_check(rec, pool[:4], conf, torch.device("cpu"), direct, WEIGHTS)
    assert numbers == want
    assert list(trace0["result"]["checks"]) == list(check.ORDER)


def test_trace0_leaves_the_recorder_off(trace0):
    assert trace0["enable_calls"] == 0
    assert trace0["enabled"] == [False] * 6
    (rr,) = trace0["run"]
    assert rr.program_spans is None and rr.program_counters is None
    assert rr.program_ms_per_frame("detect") is None
    assert trace0["result"]["correct"], trace0["result"]["checks"]


def test_trace1_hands_program_spans_and_counters_to_the_readers(tmp_path):
    root = tiny_root(str(tmp_path))
    seen = {}
    res = _run(root, "tiny", 1, {"run": lambda rr: seen.update(rr=rr)}, seconds="3")
    assert not spans.enabled() and spans.drain() == []
    assert res["correct"], res["checks"]
    rr = seen["rr"]
    assert {"detect", "track"} <= {p.name for p in rr.program_spans}
    # on the CPU the chunk runs step by step, counted as not on the card
    assert rr.program_counters["graph_replays"] == 0
    assert rr.program_counters["eager_chunks.device"] > 0
    assert rr.traced_frames > 0 and rr.traced_frames % rr.frames_per_chunk == 0
    assert rr.config["camera"]["height"] == 288
    assert rr.traffic["streams"] == 2
    m = res["metrics"]
    for name in ("detect_ms_per_frame", "track_ms_per_frame"):
        assert m[name]["value"] == manifest.metric_reader(name, root)(rr) > 0
    assert (m["detect_ms_per_frame"]["value"] + m["track_ms_per_frame"]["value"]
            <= m["submit_ms_per_frame"]["value"])
    assert "program_idle" in rr.trace


def test_kernel_table_sums_by_short_name():
    spans_ = [("pack", 50e-6, 90e-6), ("submit", 90e-6, 400e-6), ("events", 400e-6, 500e-6)]
    r = devtrace.reduce(FIXTURE, spans_, 1000.0)
    # the two kernels inside the window; late_kernel (2000 us) lies past it
    assert r["kernel_table"] == {
        "elementwise_kernel": {"seconds": pytest.approx(50e-6, abs=1e-12), "launches": 1},
        "nms_greedy_kernel": {"seconds": pytest.approx(20e-6, abs=1e-12), "launches": 1}}
    events, _ = devtrace.load(FIXTURE)
    kernels = [e for e in events if e.get("ph") == "X" and e["cat"] == "kernel"
               and e["ts"] < 500]
    assert sum(x["launches"] for x in r["kernel_table"].values()) == len(kernels)
    assert r["k1_launches"] == r["kernel_table"]["nms_greedy_kernel"]["launches"]
