"""``tools/compare_trackers_torch.py`` against ``tools/compare_trackers.py`` on
the CPU, at reduced frames.

The port's tool builds the same four scenarios pixel for pixel and, through
its own tracker facade and ``mot_eval``, gives the same metrics (IDF1, MOTA,
HOTA, DetA, AssA, ID switches) as the reference tool: every row of stopgo
and shake, and two rows of bounce and dense (their other rows are stopgo's
configurations).  The
``deepsort_random_embedder`` row is held with the reference's own random
embedder init carried into the port, since the port's seeded init is its
own.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import tools.compare_trackers as ref_tool
import tools.compare_trackers_torch as port_tool
from rtmodt_tpu.models.embedder import _flatten as jax_flatten
from rtmodt_tpu.models.embedder import init_embedder as jax_init_embedder

EMBEDDER = "checkpoints/embedder.npz"
SCENARIOS = {"bounce": 12, "stopgo": 12, "shake": 8, "dense": 6}


def _reference_build(scenario, frames):
    if scenario == "stopgo":
        return ref_tool.build_stopgo(frames, 4)
    if scenario == "dense":
        return ref_tool.build_dense(frames, 12)
    if scenario == "shake":
        return ref_tool.build_shake(frames, 4)
    return ref_tool.build_scenario(frames, 2)


@pytest.fixture(scope="module")
def reference_random_embedder(tmp_path_factory):
    _, params = jax_init_embedder((64, 32), 128, "")
    path = str(tmp_path_factory.mktemp("emb") / "reference_init.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in
                      jax_flatten(jax.device_get(params)).items()})
    return path


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_same_metrics_as_the_reference_tool(scenario, reference_random_embedder):
    frames = SCENARIOS[scenario]
    port_frames, port_gt = port_tool.build(scenario, frames, pairs=2, objects=12)
    ref_frames, ref_gt = _reference_build(scenario, frames)
    assert all(np.array_equal(a, b) for a, b in zip(port_frames, ref_frames))
    assert port_gt.keys() == ref_gt.keys()
    rows = port_tool.tracker_configs(scenario, EMBEDDER)
    assert len(rows) == 6
    if scenario in ("bounce", "dense"):
        # the same six configurations as stopgo: two rows hold the scenario
        rows = [r for r in rows if r[0] in ("bytetrack_canonical", "deepsort_trained_embedder")]
    for name, kwargs in rows:
        want = ref_tool.run_tracker(name, kwargs, ref_frames, ref_gt)
        if name == "deepsort_random_embedder":
            kwargs = dict(kwargs, deepsort=dict(kwargs["deepsort"],
                                                embedder=reference_random_embedder))
        got = port_tool.run_tracker(name, kwargs, port_frames, port_gt, device="cpu")
        assert got == want, name


def test_main_prints_every_row(tmp_path, capsys):
    out = tmp_path / "rows.json"
    results = port_tool.main(["--scenario", "stopgo", "--frames", "10", "--pairs", "1",
                              "--cpu", "--json", str(out)])
    printed = capsys.readouterr().out
    assert set(results) == {"bytetrack_reference_iou", "bytetrack_canonical",
                            "deepsort_random_embedder", "ocsort", "botsort",
                            "deepsort_trained_embedder"}
    for name, row in results.items():
        assert name in printed and 0.0 <= row["idf1"] <= 1.0
    assert out.exists()
