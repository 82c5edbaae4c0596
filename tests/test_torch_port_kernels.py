"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch: ``python -m pytest --noconftest -m cuda
tests/test_torch_port_kernels.py``.  Where there is no card the kernel tests
skip (a CUDA kernel has no CPU mode); the CPU-side tests here hold the
wrapper's plain route.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtmodt_tpu_torch.ops import nms_kernel
from rtmodt_tpu_torch.ops.nms import CLASS_OFFSET


def nms_case(name: str, seed: int, b: int = 16, k: int = 300):
    """B frames of K score-sorted candidates: boxes (B, K, 4), scores (B, K)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 560, (b, k, 2))
    wh = rng.uniform(8, 160, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0.05, 1, (b, k)), axis=1).astype(np.float32)
    if name == "ties":
        boxes[:, 1::3] = boxes[:, 0::3][:, : boxes[:, 1::3].shape[1]]
        scores[:] = np.repeat(scores[:, ::3], 3, axis=1)[:, :k]
    elif name == "zero_score":
        scores[:, k // 2:] = 0.0
    elif name == "class_offset":
        cls = rng.integers(0, 8, (b, k, 1)).astype(np.float32)
        boxes = boxes + cls * np.float32(CLASS_OFFSET)
    return torch.from_numpy(boxes), torch.from_numpy(scores)


NAMES = ("random", "ties", "zero_score", "class_offset")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the NMS kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_take_the_plain_version(name):
    boxes, scores = nms_case(name, 0, b=2, k=64)
    before = nms_kernel.launches
    got = nms_kernel.greedy_suppress(boxes, scores, 0.45)
    assert nms_kernel.launches == before
    assert torch.equal(got, nms_kernel.greedy_suppress_reference(boxes, scores, 0.45))
    assert not got[scores <= 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_kernel_matches_plain_version(cuda_device, name, seed):
    boxes, scores = nms_case(name, seed)
    want = nms_kernel.greedy_suppress_reference(boxes, scores, 0.45)
    before = nms_kernel.launches
    got = nms_kernel.greedy_suppress(boxes.to(cuda_device), scores.to(cuda_device), 0.45)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_nms_kernel_rejects_what_it_does_not_take(cuda_device):
    boxes, scores = nms_case("random", 2, b=1, k=2048)
    with pytest.raises(ValueError):
        nms_kernel.greedy_suppress(boxes.to(cuda_device), scores.to(cuda_device), 0.45)
    with pytest.raises(ValueError):
        nms_kernel.greedy_suppress(boxes.to(cuda_device)[:, ::2], scores.to(cuda_device)[:, ::2].contiguous(), 0.45)
