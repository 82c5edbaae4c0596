"""Suppress-and-pack past the kernel's one-CTA limit (K > 1024) against the
JAX reference.

``detection.nms_candidates`` is not capped by either package's loader, and
the reference's default ``nms_impl: fixpoint`` suppresses any K. The port's
``ops/nms.py::suppress_and_pack`` hands every K to K1, whose wide path
(K > 1024) runs on the card only; on the CPU the wrapper takes the plain
version. Here that route is held to the JAX ``_suppress_and_pack(...,
impl="fixpoint")`` at K = 1025 and 2048, one and four frames, on scenes made
from a numpy seed: random boxes, scattered zero scores, identical boxes,
eight classes (the class offset separates them), and a zero-score tail.
Every output must be equal: boxes and scores bit for bit, classes, masks and
counts exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.ops.nms import _suppress_and_pack
from rtmodt_tpu_torch.ops import nms_kernel
from rtmodt_tpu_torch.ops.nms import suppress_and_pack
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

IOU, MAX_DET = 0.45, 300


def scene(name: str, seed: int, b: int, k: int):
    """B frames of K score-sorted candidates: boxes (B, K, 4) in model pixels,
    scores (B, K), classes (B, K) int32."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 560, (b, k, 2))
    wh = rng.uniform(8, 160, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.05, 1, (b, k)), axis=1).astype(np.float32)
    classes = np.zeros((b, k), np.int32)
    if name == "holes":
        scores[rng.uniform(size=(b, k)) < 0.3] = 0.0
    elif name == "identical":
        boxes[:] = boxes[:, :1]
    elif name == "class_offset":
        classes = rng.integers(0, 8, (b, k)).astype(np.int32)
    elif name == "zero_tail":
        scores[:, k // 3:] = 0.0
    return boxes, scores, classes


@functools.lru_cache(maxsize=None)
def jax_pack(k: int):
    return jax.jit(lambda bx, sc, cl: _suppress_and_pack(bx, sc, cl, IOU, MAX_DET, k, False,
                                                         "fixpoint"))


CASES = [(name, k, b) for name in ("random", "holes", "identical", "class_offset", "zero_tail")
         for k in (1025, 2048) for b in (1, 4)]


@pytest.mark.parametrize("name,k,b", CASES)
def test_twin_suppress_and_pack_equals_jax_fixpoint(name, k, b):
    boxes, scores, classes = scene(name, seed=k + b, b=b, k=k)
    before = nms_kernel.launches
    got = suppress_and_pack(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(classes), IOU, MAX_DET)
    assert nms_kernel.launches == before          # CPU tensors: the plain version
    for f in range(b):
        want = jax_pack(k)(jnp.asarray(boxes[f]), jnp.asarray(scores[f]),
                           jnp.asarray(classes[f]))
        for field in ("boxes", "scores", "classes", "valid", "count"):
            np.testing.assert_array_equal(getattr(got, field)[f].numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"{field} of frame {f}")
    assert int(got.count.min()) > 0
    if name == "identical":                       # one box survives a frame
        assert got.count.tolist() == [1] * b
