"""The round counters: ``ops/nms.py::nms_debug_from_logits`` (with its plain
torch fixpoint suppression) and ``ops/assignment.py::greedy_assign_rounds``
against the JAX package's, on the dense scenes of
tests/test_dense_scenes.py::TestRoundDiagnostics and on head outputs.

Keep masks, round counts, pool sizes and survivors must be equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.ops.assignment import greedy_assign_rounds as jax_rounds
from rtmodt_tpu.ops.iou import pairwise_iou as jax_iou
from rtmodt_tpu.ops.nms import _greedy_suppress as jax_fixpoint
from rtmodt_tpu.ops.nms import nms_debug_from_logits as jax_debug
from rtmodt_tpu_torch.ops.assignment import greedy_assign, greedy_assign_rounds
from rtmodt_tpu_torch.ops.iou import pairwise_iou
from rtmodt_tpu_torch.ops.nms import greedy_suppress_fixpoint, nms_debug_from_logits
from rtmodt_tpu_torch.ops.nms_kernel import greedy_suppress_reference
from tests.test_dense_scenes import _np_iou, dense_cluster_scene


@pytest.mark.parametrize("n", [1, 64, 128])
def test_fixpoint_suppression_equals_the_reference(n):
    rng = np.random.default_rng(42 + n)
    boxes = dense_cluster_scene(rng, n)
    scores = np.sort(rng.uniform(0.05, 1.0, n).astype(np.float32))[::-1].copy()
    scores[n // 2::7] = 0.0                      # zero-score rows never suppress
    want_keep, want_rounds = jax_fixpoint(jax_iou(jnp.asarray(boxes), jnp.asarray(boxes)),
                                          jnp.asarray(scores), 0.5)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    keep, rounds = greedy_suppress_fixpoint(pairwise_iou(b, b), s, 0.5)
    assert np.array_equal(keep.numpy(), np.asarray(want_keep))
    assert rounds == int(want_rounds) and (n < 64 or rounds > 2)
    # the fixpoint is the greedy suppression K1's plain version computes
    plain = greedy_suppress_reference(b[None], s[None], 0.5)[0]
    assert torch.equal(keep & (s > 0), plain)


@pytest.mark.parametrize("thr", [0.1, 0.5])
def test_assign_rounds_equal_the_reference(thr):
    rng = np.random.default_rng(42)
    a = dense_cluster_scene(rng, 96)
    b = a + rng.normal(0, 6.0, a.shape).astype(np.float32)
    sim = _np_iou(a, b).astype(np.float32)
    rounds = greedy_assign_rounds(torch.from_numpy(sim), thr)
    assert rounds == int(jax_rounds(jnp.asarray(sim), thr))
    assert rounds == greedy_assign(torch.from_numpy(sim), thr).rounds and rounds >= 1


@pytest.mark.parametrize("agnostic,mask", [(False, None), (True, None), (False, [0, 2, 5])])
def test_nms_debug_equals_the_reference(agnostic, mask):
    """Head outputs of 128 px (336 anchors, 8 classes) with dense confident
    clusters: (rounds, pool used, kept) as the reference counts them."""
    rng = np.random.default_rng(7)
    a, c = 336, 8
    box_dist = rng.normal(0, 2.0, (a, 64)).astype(np.float32)
    logits = rng.normal(-4.0, 2.5, (a, c)).astype(np.float32)
    logits[rng.random(a) < 0.4] += 5.0
    cm = None if mask is None else np.isin(np.arange(c), mask)
    want = jax_debug(jnp.asarray(box_dist), jnp.asarray(logits), 128, 0.25, 0.45,
                     num_candidates=300, class_mask=None if cm is None else jnp.asarray(cm),
                     agnostic=agnostic)
    got = nms_debug_from_logits(torch.from_numpy(box_dist), torch.from_numpy(logits), 128,
                                0.25, 0.45, num_candidates=300,
                                class_mask=None if cm is None else torch.from_numpy(cm),
                                agnostic=agnostic)
    assert got == tuple(int(x) for x in want)
    assert got[1] > 50 and got[2] < got[1]
