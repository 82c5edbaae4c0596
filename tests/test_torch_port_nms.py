"""The port's NMS (rtmodt_tpu_torch/ops/nms*.py) against the JAX reference.

The plain version of the CUDA kernel (``greedy_suppress_reference``) must
equal the sequential oracle, the Pallas kernel in interpret mode and the
XLA fixpoint exactly (keep masks are booleans: no tolerance); the kernel is
held to the plain version on the card by tests/test_torch_port_kernels.py.
Candidate decode and packing are
held to the JAX functions exactly on indices, classes and masks, at 1e-5 on
scores (sigmoid differs by an ulp or two between XLA and PyTorch) and at
BOX_ATOL on box coordinates (see there).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.ops.iou import pairwise_iou
from rtmodt_tpu.ops.nms import _greedy_suppress, batched_nms_from_logits as jax_nms
from rtmodt_tpu.ops.pallas.nms_kernel import pallas_greedy_suppress
from rtmodt_tpu_torch.ops import nms_kernel
from rtmodt_tpu_torch.ops.nms import (CLASS_OFFSET, batched_nms_from_logits,
                                      candidates_from_logits)
from rtmodt_tpu_torch.ops.nms_kernel import greedy_suppress, greedy_suppress_reference
from tests.conftest import random_boxes
from tests.test_pallas_kernels import np_greedy_nms_keep


def _case(name: str, seed: int, n: int = 64):
    """(boxes (n, 4) f32 sorted-by-score candidates, scores (n,), thresh)."""
    rng = np.random.default_rng(seed)
    boxes = random_boxes(rng, n, w=300, h=300, min_size=40, max_size=150)
    scores = np.sort(rng.uniform(0.05, 1, n).astype(np.float32))[::-1].copy()
    if name == "ties":
        # duplicated boxes and equal scores: IoU exactly 1 and 0 pairs
        boxes[1::4] = boxes[0::4][: len(boxes[1::4])]
        scores[:] = np.repeat(scores[::4], 4)[:n]
    elif name == "zero_pad":
        scores[-16:] = 0.0
    elif name == "class_offset":
        cls = rng.integers(0, 4, n).astype(np.float32)
        boxes = boxes + (cls * CLASS_OFFSET)[:, None]
    elif name == "dense":
        boxes = random_boxes(rng, n, w=120, h=120, min_size=30, max_size=90)
    return boxes, scores, 0.45 if name != "dense" else 0.3


# A decoded coordinate is anchor -+ stride * E[bin]: a difference of terms of
# up to ~500 model pixels (anchor + 15 bins x stride 32), where one f32 ulp is
# 6.1e-5; the softmax sums in another order in XLA and PyTorch, so near-
# cancelling coordinates differ by an ulp of those terms, not of the result.
BOX_ATOL = 1e-4

CASES = [(name, seed) for name in ("random", "ties", "zero_pad", "class_offset", "dense")
         for seed in (0, 1)]


@pytest.mark.parametrize("name,seed", CASES)
def test_plain_version_matches_sequential_oracle(name, seed):
    boxes, scores, t = _case(name, seed)
    got = greedy_suppress_reference(torch.from_numpy(boxes)[None],
                                    torch.from_numpy(scores)[None], t)[0].numpy()
    np.testing.assert_array_equal(got, np_greedy_nms_keep(boxes, scores, t))


@pytest.mark.parametrize("name,seed", CASES)
def test_plain_version_matches_pallas_and_fixpoint(name, seed):
    boxes, scores, t = _case(name, seed)
    got = greedy_suppress_reference(torch.from_numpy(boxes)[None],
                                    torch.from_numpy(scores)[None], t)[0].numpy()
    pallas = np.asarray(pallas_greedy_suppress(jnp.asarray(boxes), jnp.asarray(scores),
                                               t, interpret=True))
    fix = np.asarray(_greedy_suppress(pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes)),
                                      jnp.asarray(scores), t)[0]) & (scores > 0)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, fix)


def test_batched_plain_version_is_per_frame():
    cases = [_case(name, 3) for name in ("random", "zero_pad", "class_offset")]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases]))
    scores = torch.from_numpy(np.stack([c[1] for c in cases]))
    got = greedy_suppress_reference(boxes, scores, 0.45)
    for i, (b, s, _) in enumerate(cases):
        np.testing.assert_array_equal(got[i].numpy(), np_greedy_nms_keep(b, s, 0.45))


def test_wrapper_uses_plain_version_on_cpu_and_validates():
    boxes, scores, t = _case("zero_pad", 5)
    b, s = torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None]
    before = nms_kernel.launches
    assert torch.equal(greedy_suppress(b, s, t), greedy_suppress_reference(b, s, t))
    assert nms_kernel.launches == before          # CPU tensors launch nothing
    with pytest.raises(TypeError):
        greedy_suppress(b.double(), s, t)
    with pytest.raises(ValueError):
        greedy_suppress(b[0], s, t)
    with pytest.raises(ValueError):
        greedy_suppress(b, s[:, :10], t)


def _head_outputs(seed: int, b: int = 3, a: int = 336, c: int = 8):
    """Raw head outputs for a 128 px input (A = 16^2 + 8^2 + 4^2 = 336)."""
    rng = np.random.default_rng(seed)
    box_dist = rng.normal(0, 2, (b, a, 64)).astype(np.float32)
    cls = rng.normal(-3, 2, (b, a, c)).astype(np.float32)
    cls[:, ::7] = cls[:, 3:4]            # tied logits across anchors
    return box_dist, cls


@pytest.mark.parametrize("seed,classes", [(0, None), (1, [0, 1, 2, 3, 5, 7])])
def test_candidates_match_jax(seed, classes):
    from rtmodt_tpu.ops.nms import _candidates_from_logits

    box_dist, cls = _head_outputs(seed)
    mask = None if classes is None else np.isin(np.arange(8), classes)
    tb, ts, tc, k = candidates_from_logits(
        torch.from_numpy(box_dist), torch.from_numpy(cls), 128, 0.05, 100,
        None if mask is None else torch.from_numpy(mask))
    for i in range(box_dist.shape[0]):
        jb, js, jc, jk = _candidates_from_logits(
            jnp.asarray(box_dist[i]), jnp.asarray(cls[i]), 128, 0.05, 100,
            None if mask is None else jnp.asarray(mask))
        assert k == jk
        np.testing.assert_array_equal(tc[i].numpy(), np.asarray(jc))
        np.testing.assert_allclose(ts[i].numpy(), np.asarray(js), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tb[i].numpy(), np.asarray(jb), rtol=1e-5, atol=BOX_ATOL)


@pytest.mark.parametrize("seed,agnostic,max_det,cand",
                         [(0, False, 100, 300), (1, True, 50, 300), (2, False, 100, 60)])
def test_batched_nms_matches_jax(seed, agnostic, max_det, cand):
    box_dist, cls = _head_outputs(seed)
    got = batched_nms_from_logits(torch.from_numpy(box_dist), torch.from_numpy(cls), 128,
                                  0.05, 0.45, max_det, cand, agnostic=agnostic)
    want = jax.vmap(lambda bd, cl: jax_nms(bd, cl, 128, 0.05, 0.45, max_det, cand,
                                           agnostic=agnostic))(jnp.asarray(box_dist),
                                                               jnp.asarray(cls))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5,
                               atol=BOX_ATOL)
    assert got.count.min() > 0
