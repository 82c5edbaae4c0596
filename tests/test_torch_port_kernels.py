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
from tools.nms_kernel_times_torch import WIDE_EDGE_CASES, WIDE_EDGE_K


def nms_case(name: str, seed: int, b: int = 16, k: int = 300, valid: int | None = None):
    """B frames of K score-sorted candidates: boxes (B, K, 4), scores (B, K);
    with ``valid``, only the first ``valid`` rows of a frame score above 0."""
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
    elif name == "holes":           # zero scores anywhere, not only a suffix
        scores[rng.uniform(size=(b, k)) < 0.3] = 0.0
    elif name == "identical":       # every pair conflicts
        boxes[:] = boxes[:, :1]
    elif name == "no_valid":
        scores[:] = 0.0
    elif name == "one_valid":
        at = rng.integers(0, k, (b, 1))
        scores[np.arange(k)[None, :] != at] = 0.0
    elif name == "degenerate":      # zero-width and inverted boxes: zero or negative areas
        boxes[:, 0::3, 2] = boxes[:, 0::3, 0]
        boxes[:, 1::3, 0], boxes[:, 1::3, 2] = boxes[:, 1::3, 2].copy(), boxes[:, 1::3, 0].copy()
    elif name == "disjoint":        # 10 px boxes on a 16 px grid: no pair overlaps
        cell = np.arange(k)
        xy = np.stack([cell % 64, cell // 64], axis=-1) * 16.0
        boxes[:] = np.concatenate([xy, xy + 10.0], axis=-1).astype(np.float32)
    elif name == "one_late":        # the only valid row is the frame's last
        scores[:, :-1] = 0.0
    elif name == "chain":           # each box overlaps the next (IoU 7/13), not the one after
        x = (np.arange(k) % 200) * 3.0 + (np.arange(k) // 200) * 1000.0
        boxes[:] = np.stack([x, 0 * x, x + 10.0, 0 * x + 10.0], axis=-1).astype(np.float32)
    if valid is not None:
        scores[:, valid:] = 0.0
    return torch.from_numpy(boxes), torch.from_numpy(scores)


NAMES = ("random", "ties", "zero_score", "class_offset", "holes", "identical",
         "no_valid", "one_valid", "degenerate", "disjoint", "one_late", "chain")
# (name, seed, B, K, threshold): every case at the main path's shapes, then
# the one-CTA kernel's edges (K across the 32-row blocks up to its 1024, one
# frame and 64 frames), then thresholds where the kernel's zero-overlap
# decision, made without the divide, differs from 'no conflict' (t < 0) or
# makes any overlap one (t = 0), then the wide path (K > 1024: every anchor
# of a 640 input is 8400)
KERNEL_CASES = ([(name, seed, 16, 300, 0.45) for name in NAMES for seed in (0, 1)]
                + [("holes", k, 16, k, 0.45) for k in (1, 33, 65, 300, 1024)]
                + [(name, k, b, k, 0.45) for name, b, k in (
                    ("random", 16, 1024), ("random", 1, 300), ("holes", 1, 65),
                    ("random", 64, 300), ("holes", 64, 300), ("identical", 1, 1024),
                    ("no_valid", 1, 33), ("one_valid", 16, 1024))]
                + [(name, 5, 16, 300, t) for name in ("random", "degenerate")
                   for t in (-0.1, 0.0, 0.9999)]
                + [(name, k, b, k, 0.45) for name, b, k in (
                    ("random", 1, 1025), ("holes", 1, 1025), ("identical", 1, 1025),
                    ("random", 16, 2048), ("holes", 16, 2048), ("one_valid", 16, 2048),
                    ("random", 2, 8400), ("class_offset", 2, 8400))])
# K from which the plain version runs on the card: its (B, K, K) conflict
# matrix and fixpoint rounds take seconds on the host there
PLAIN_ON_CARD_K = 8400


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
@pytest.mark.parametrize("name,seed,b,k,t", KERNEL_CASES)
def test_nms_kernel_matches_plain_version(cuda_device, name, seed, b, k, t):
    boxes, scores = nms_case(name, seed, b=b, k=k)
    plain_dev = cuda_device if k >= PLAIN_ON_CARD_K else torch.device("cpu")
    want = nms_kernel.greedy_suppress_reference(boxes.to(plain_dev), scores.to(plain_dev),
                                                t).cpu()
    before = nms_kernel.launches
    got = nms_kernel.greedy_suppress(boxes.to(cuda_device), scores.to(cuda_device), t)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("name,valid,t", WIDE_EDGE_CASES)
def test_nms_kernel_wide_tile_boundaries(cuda_device, name, valid, t, b):
    boxes, scores = nms_case(name, 11, b=b, k=WIDE_EDGE_K, valid=valid)
    want = nms_kernel.greedy_suppress_reference(boxes.to(cuda_device), scores.to(cuda_device),
                                                t).cpu()
    before = nms_kernel.launches
    got = nms_kernel.greedy_suppress(boxes.to(cuda_device), scores.to(cuda_device), t)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    assert torch.equal(got.cpu(), want)
    if name == "identical":
        assert want.sum(dim=1).tolist() == [1] * b
    if name == "disjoint" and t >= 0:
        assert torch.equal(want, scores > 0)
    if name == "chain":             # every other box of a chain survives
        assert torch.equal(want, (scores > 0) & (torch.arange(WIDE_EDGE_K) % 200 % 2 == 0))


@pytest.mark.cuda
def test_nms_kernel_rejects_what_it_does_not_take(cuda_device):
    # K = 2048 is past the one-CTA kernel's 1024: the wide path takes it
    boxes, scores = nms_case("random", 2, b=1, k=2048)
    got = nms_kernel.greedy_suppress(boxes.to(cuda_device), scores.to(cuda_device), 0.45)
    assert torch.equal(got.cpu(), nms_kernel.greedy_suppress_reference(boxes, scores, 0.45))
    with pytest.raises(ValueError):
        nms_kernel.greedy_suppress(boxes.to(cuda_device)[:, ::2], scores.to(cuda_device)[:, ::2].contiguous(), 0.45)
    boxes, scores = nms_case("random", 2, b=1, k=300)
    flat = torch.cat([torch.zeros(1), boxes.flatten()]).to(cuda_device)
    with pytest.raises(ValueError):                  # float4 loads need 16-byte alignment
        nms_kernel.greedy_suppress(flat[1:].view(1, 300, 4), scores.to(cuda_device), 0.45)


@pytest.mark.cuda
def test_nccl_world_1_sharded_step_is_the_plain_step(cuda_device):
    """One rank over NCCL: its all-reduces are the identity, so the
    data-parallel step gives the plain step's parameters, BN statistics and
    metrics bit for bit (yolov8n, 64 px, B = 2, float32, two AdamW steps)."""
    from rtmodt_tpu_torch.models.yolov8 import build_model, init_params
    from rtmodt_tpu_torch.parallel import mesh as M
    from rtmodt_tpu_torch.parallel.ranks import plain_vs_sharded

    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
                np.tile(np.asarray([[[8, 8, 40, 40], [20, 20, 60, 60]]], np.float32), (2, 1, 1)),
                np.zeros((2, 2), np.int32), np.ones((2, 2), bool)) for _ in range(2)]
    model = init_params(build_model("yolov8n", 4), torch.Generator().manual_seed(0))
    spec = {"model": "yolov8n", "num_classes": 4, "input_size": 64,
            "state": model.state_dict(), "batches": batches,
            "optimizer": {"lr0": 1e-3, "lrf": 0.01, "total": 8, "warmup": 1}}
    mesh = M.create_mesh(devices=["cuda:0"])
    assert mesh.backend == "nccl"
    out = M.spawn(plain_vs_sharded, mesh, spec, timeout=300)[0]
    assert out["backend"] == "nccl"
    assert out["gap_repeat"] == 0.0, "the plain step does not repeat bit for bit"
    assert out["gap_sharded"] == 0.0
    assert out["metrics"]["sharded"] == out["metrics"]["plain"]

