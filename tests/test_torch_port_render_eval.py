"""The renderer, the MOT evaluation and the synthetic scenes against the JAX
package's.

``FrameRenderer.render`` must give pixel-equal frames for the same tracks
and zones (every overlay on, and each one off).  ``evaluate_mot`` and
``evaluate_hota`` must give identical metrics (exact) on the same seeded
ground-truth and hypothesis dicts, and ``load_mot_txt`` the same dicts.
``dense_moving_scene`` must be pixel-identical, with identical boxes,
labels and ids.
"""

from __future__ import annotations

import numpy as np
import pytest

from rtmodt_tpu.evaluation.mot_eval import evaluate_hota as jax_hota
from rtmodt_tpu.evaluation.mot_eval import evaluate_mot as jax_mot
from rtmodt_tpu.evaluation.mot_eval import load_mot_txt as jax_load_mot
from rtmodt_tpu.utils.synthetic import dense_moving_scene as jax_dense
from rtmodt_tpu.visualization.renderer import FrameRenderer as JaxRenderer
from rtmodt_tpu_torch.evaluation.mot_eval import evaluate_hota, evaluate_mot, load_mot_txt
from rtmodt_tpu_torch.tracking.tracker import Track
from rtmodt_tpu_torch.utils.synthetic import dense_moving_scene, moving_boxes_frame
from rtmodt_tpu_torch.visualization.renderer import FrameRenderer
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

ZONES = [("restricted", np.array([[40, 60], [300, 60], [300, 250], [40, 250]], np.int32)),
         ("gate", np.array([[320, 20], [500, 40], [480, 270], [340, 200]], np.int32))]


def _tracks(rng, n=9):
    out = []
    for i in range(n):
        x, y = rng.uniform(-20, 480), rng.uniform(-10, 260)
        trail = [(int(x + 4 * k), int(y + 2 * k)) for k in range(int(rng.integers(0, 40)))]
        out.append(Track(track_id=int(rng.integers(1, 60)),
                         xyxy=np.array([x, y, x + 60.7, y + 40.2], np.float32),
                         confidence=float(rng.uniform(0, 1)), class_id=i % 3,
                         class_name=["person", "car", ""][i % 3], trail=trail))
    return out


@pytest.mark.parametrize("off", [None, "show_boxes", "show_labels", "show_trails",
                                 "show_zones", "show_hud"])
def test_render_is_pixel_equal(off):
    rng = np.random.default_rng(5)
    frame, _ = moving_boxes_frame(3, 288, 512, 6, seed=1)
    tracks = _tracks(rng)
    kw = {off: False} if off else {}
    got = FrameRenderer(trail_length=12, **kw).render(frame.copy(), tracks, ZONES,
                                                      fps=23.456, latency_ms=41.7)
    want = JaxRenderer(trail_length=12, **kw).render(frame.copy(), tracks, ZONES,
                                                     fps=23.456, latency_ms=41.7)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, frame)


def _mot_dicts(seed, n_frames=30, n_gt=12):
    """GT trajectories and a noisy hypothesis: jitter, misses, false
    positives and an identity swap."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 600, (n_gt, 2))
    vel = rng.uniform(-5, 5, (n_gt, 2))
    gt, pred = {}, {}
    for f in range(1, n_frames + 1):
        gt[f], pred[f] = {}, {}
        for g in range(n_gt):
            if rng.uniform() < 0.05:
                continue
            xy = base[g] + vel[g] * f
            gt[f][g + 1] = np.array([xy[0], xy[1], 40.0, 80.0])
            if rng.uniform() < 0.1:
                continue
            pid = 100 + g if not (g == 3 and f > n_frames // 2) else 100 + 4
            if g == 4 and f > n_frames // 2:
                pid = 100 + 3
            pred[f][pid] = gt[f][g + 1] + np.append(rng.normal(0, 4, 2), rng.normal(0, 2, 2))
        for k in range(int(rng.integers(0, 3))):
            pred[f][900 + k] = np.append(rng.uniform(0, 600, 2), [30.0, 30.0])
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mot_metrics_are_identical(seed):
    gt, pred = _mot_dicts(seed)
    got = evaluate_mot(gt, pred)
    assert got == jax_mot(gt, pred)
    assert evaluate_hota(gt, pred) == jax_hota(gt, pred)
    assert 0 < got["idf1"] < 1 and got["num_switches"] > 0
    assert evaluate_hota({}, {}) == jax_hota({}, {})


def test_load_mot_txt_is_identical(tmp_path):
    gt, _ = _mot_dicts(4, n_frames=5)
    path = tmp_path / "gt.txt"
    with open(path, "w") as f:
        for fr, objs in gt.items():
            for tid, b in objs.items():
                f.write(f"{fr},{tid},{b[0]:.2f},{b[1]:.2f},{b[2]:.2f},{b[3]:.2f},1,-1,-1,-1\n")
        f.write("garbage\n")
    got, want = load_mot_txt(str(path)), jax_load_mot(str(path))
    assert got.keys() == want.keys()
    for fr in got:
        assert got[fr].keys() == want[fr].keys()
        for tid in got[fr]:
            np.testing.assert_array_equal(got[fr][tid], want[fr][tid])


@pytest.mark.parametrize("t,n_objects,seed", [(0, 16, 5), (37, 64, 5), (5, 24, 1)])
def test_dense_scene_is_pixel_identical(t, n_objects, seed):
    got = dense_moving_scene(t, 180, 320, n_objects=n_objects, seed=seed)
    want = jax_dense(t, 180, 320, n_objects=n_objects, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
