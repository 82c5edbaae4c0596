"""The port's training loss pieces against the JAX package's on the CPU, on
inputs drawn with numpy (64 px, so A = 84 anchors; B = 2, M = 4, C = 4):
``ops/iou.py::ciou`` and its gradient, ``models/yolov8.py::
decode_predictions``, ``training/assigner.py::assign`` (random scenes,
empty GT, the top-k cap, tied metrics) and ``training/loss.py::yolo_loss``.

Measured here (bars in brackets): CIoU 6.0e-8 [1e-6], its gradient 7.5e-9
[1e-5] (with ``alpha`` detached, as ultralytics computes it, the gradient
moves by 1.3e-2 [must exceed 1e-3]); decode 1.2e-4 px on boxes of up to
~500 px [1e-5 + 1e-5 |x|], scores 1.5e-8 [1e-6]; assigner fg masks and GT
indices equal, targets 9.3e-10 [1e-6]; loss parts 3.1e-7 relative [1e-5],
num_fg equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.models.yolov8 import decode_predictions as jax_decode
from rtmodt_tpu.models.yolov8 import make_anchors as jax_anchors
from rtmodt_tpu.ops.iou import ciou as jax_ciou
from rtmodt_tpu.training.assigner import assign as jax_assign
from rtmodt_tpu.training.loss import yolo_loss as jax_yolo_loss
from rtmodt_tpu_torch.models.yolov8 import REG_MAX, decode_predictions, make_anchors
from rtmodt_tpu_torch.ops.iou import box_iou, ciou
from rtmodt_tpu_torch.training.assigner import assign
from rtmodt_tpu_torch.training.loss import yolo_loss
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)
from tests.test_torch_port_train_step import synth_batch

S, B, M, NC = 64, 2, 4, 4
A = sum((S // s) ** 2 for s in (8, 16, 32))


def random_boxes(rng, shape, lo=2.0, hi=60.0):
    xy = rng.uniform(0, S - hi / 2, shape + (2,))
    wh = rng.uniform(lo, hi / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def heads(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, (B, A, 4 * REG_MAX)).astype(np.float32),
            rng.normal(-2, 2, (B, A, NC)).astype(np.float32))


def test_ciou_and_its_gradient_through_alpha():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, (256,)), random_boxes(rng, (256,))
    np.testing.assert_allclose(ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_ciou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-6)
    want = np.asarray(jax.grad(lambda x: jax_ciou(x, jnp.asarray(b)).sum())(jnp.asarray(a)))
    ta = torch.from_numpy(a).requires_grad_()
    ciou(ta, torch.from_numpy(b)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), want, rtol=0, atol=1e-5)

    # ultralytics' alpha (computed without gradient) gives another gradient
    tb = torch.from_numpy(a).requires_grad_()
    ciou_alpha_detached(tb, torch.from_numpy(b)).sum().backward()
    assert float(np.abs(tb.grad.numpy() - want).max()) > 1e-3


def ciou_alpha_detached(x, y, eps=1e-7):
    """``ciou`` with ultralytics' ``alpha`` under ``no_grad``: the same values."""
    iou = box_iou(x, y, eps)
    c_wh = (torch.maximum(x[..., 2:], y[..., 2:]) - torch.minimum(x[..., :2], y[..., :2])
            ).clamp(min=0.0)
    c2 = c_wh[..., 0] ** 2 + c_wh[..., 1] ** 2 + eps
    rho2 = torch.sum(((x[..., :2] + x[..., 2:]) * 0.5 - (y[..., :2] + y[..., 2:]) * 0.5) ** 2,
                     dim=-1)
    v = (4.0 / np.pi ** 2) * (torch.atan((y[..., 2] - y[..., 0]) / (y[..., 3] - y[..., 1] + eps))
                              - torch.atan((x[..., 2] - x[..., 0])
                                           / (x[..., 3] - x[..., 1] + eps))) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + 1.0 + eps)
    return iou - rho2 / c2 - alpha * v


def test_decode_predictions_full_grid():
    bd, cl = heads(1)
    jb, js = jax_decode(jnp.asarray(bd), jnp.asarray(cl), S)
    pb, ps = decode_predictions(torch.from_numpy(bd), torch.from_numpy(cl), S)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def _assign_both(scores, boxes, gt_boxes, gt_labels, gt_mask, **kw):
    anchors = np.asarray(jax_anchors(S)[0])
    want = jax_assign(jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(anchors),
                      jnp.asarray(gt_boxes), jnp.asarray(gt_labels), jnp.asarray(gt_mask), **kw)
    got = assign(torch.from_numpy(np.array(scores)), torch.from_numpy(np.array(boxes)),
                 make_anchors(S)[0], torch.from_numpy(gt_boxes),
                 torch.from_numpy(gt_labels), torch.from_numpy(gt_mask), **kw)
    return got, want


def _same_assignment(got, want):
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(want.target_gt_idx))
    np.testing.assert_allclose(got.target_boxes.numpy(), np.asarray(want.target_boxes),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assigner_on_random_scenes(seed):
    _, gt_boxes, gt_labels, gt_mask = synth_batch(seed=seed)
    bd, cl = heads(seed + 10)
    boxes, scores = (np.asarray(x) for x in jax_decode(jnp.asarray(bd), jnp.asarray(cl), S))
    got, want = _assign_both(scores, boxes, gt_boxes, gt_labels, gt_mask)
    assert got.fg_mask.any()
    _same_assignment(got, want)


def test_assigner_empty_gt():
    scores = np.full((1, A, NC), 0.5, np.float32)
    got, want = _assign_both(scores, np.zeros((1, A, 4), np.float32),
                             np.zeros((1, 2, 4), np.float32), np.zeros((1, 2), np.int32),
                             np.zeros((1, 2), bool))
    assert not got.fg_mask.any()
    _same_assignment(got, want)


def test_assigner_topk_cap_and_tied_metrics():
    """One GT covering every anchor, every prediction the same box and score:
    all metrics tie, so top-k keeps the 10 lowest anchor indices (lax.top_k's
    order), and the second GT slot (the same box) loses every anchor to the
    first (argmax's first maximum)."""
    gt = np.array([[[0.0, 0.0, 64.0, 64.0], [0.0, 0.0, 64.0, 64.0]]], np.float32)
    scores = np.full((1, A, NC), 0.5, np.float32)
    boxes = np.tile(np.array([[[4.0, 4.0, 40.0, 40.0]]], np.float32), (1, A, 1))
    got, want = _assign_both(scores, boxes, gt, np.array([[1, 2]], np.int32),
                             np.array([[True, True]]), topk=10)
    _same_assignment(got, want)
    fg = np.flatnonzero(got.fg_mask.numpy()[0])
    assert fg.tolist() == list(range(10))
    assert (got.target_gt_idx.numpy()[0, fg] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_yolo_loss_parts(seed):
    _, gt_boxes, gt_labels, gt_mask = synth_batch(seed=seed)
    bd, cl = heads(seed + 20)
    want = jax_yolo_loss(jnp.asarray(bd), jnp.asarray(cl), jnp.asarray(gt_boxes),
                         jnp.asarray(gt_labels), jnp.asarray(gt_mask), S)
    got = yolo_loss(torch.from_numpy(bd), torch.from_numpy(cl), torch.from_numpy(gt_boxes),
                    torch.from_numpy(gt_labels), torch.from_numpy(gt_mask), S)
    for part in ("total", "box", "cls", "dfl"):
        np.testing.assert_allclose(float(getattr(got, part)), float(getattr(want, part)),
                                   rtol=1e-5, err_msg=part)
    assert int(got.num_fg) == int(want.num_fg) > 0
