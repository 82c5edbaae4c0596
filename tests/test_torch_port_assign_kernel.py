"""The greedy-assignment kernel (``csrc/assign_kernel.cu``) against its plain
version (``ops/assignment.py::greedy_assign_reference``), on the card.

Every case compares ``row_to_col``, ``col_to_row`` and ``int(rounds)`` bit
for bit with the plain version on the CPU: random and adversarial matrices
(ties along rows and columns, NaN and infinities, every entry below the
threshold, every entry equal, entries at and below -1e9 with OC-SORT's
-5e8 threshold), R < C and R > C, R or C = 0, the unbatched and (S, R, C)
forms, S = 1 and 64, the cells' (32, 256, 100) and (16, 256, 100), and a
matrix past a block's shared memory, (4, 1024, 300).  The kernel reads
nothing back to the host, so a captured launch replays in a CUDA graph.

This file imports neither JAX nor the JAX package: on the card, ``python -m
pytest --noconftest -m cuda tests/test_torch_port_assign_kernel.py``.
Without a card the kernel tests skip (a CUDA kernel has no CPU mode); the
CPU tests here hold the wrapper's plain route and its results.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtmodt_tpu_torch.ops import assignment
from rtmodt_tpu_torch.ops.assignment import (greedy_assign, greedy_assign_reference,
                                             greedy_assign_rounds)


def assign_case(name: str, seed: int, shape: tuple, masks: bool = True):
    """(similarity f32, row_valid or None, col_valid or None, threshold) of
    ``shape`` (R, C) or (S, R, C)."""
    rng = np.random.default_rng(seed)
    thr = 0.2
    if name == "random":
        sim = rng.uniform(0, 1, shape)
    elif name == "iou":            # sparse, as the trackers' IoU matrices are
        sim = rng.uniform(0, 1, shape) * (rng.uniform(size=shape) < 0.05)
    elif name == "ties":           # few distinct values: ties along rows and columns
        sim = rng.integers(0, 4, shape) / 4.0
        thr = 0.25
    elif name == "nan":
        sim = rng.uniform(-1, 1, shape)
        sim[rng.uniform(size=shape) < 0.3] = np.nan
        sim[rng.uniform(size=shape) < 0.05] = np.inf
        sim[rng.uniform(size=shape) < 0.05] = -np.inf
        thr = 0.0
    elif name == "below":          # nothing reaches the threshold
        sim = rng.uniform(0, 0.5, shape)
        thr = 0.5
    elif name == "equal":          # every entry equal: one pair a round
        sim = np.full(shape, 0.5)
    elif name == "ocsort":         # OC-SORT's -5e8 threshold over -1e9 and below
        sim = rng.choice([-2e9, -1e9, -5e8, -1.0, 0.0, 0.3], shape)
        thr = -5e8
    else:
        raise ValueError(name)
    lead = shape[:-2]
    rv = cv = None
    if masks:
        rv = rng.uniform(size=(*lead, shape[-2])) < 0.7
        cv = rng.uniform(size=(*lead, shape[-1])) < 0.8
    return (torch.from_numpy(sim.astype(np.float32)),
            None if rv is None else torch.from_numpy(rv),
            None if cv is None else torch.from_numpy(cv), thr)


def sequential_greedy(sim: np.ndarray, thr: float) -> np.ndarray:
    """Textbook greedy on one tie-free matrix: take the largest entry >=
    threshold, retire its row and column, repeat.  Returns row_to_col."""
    sim = sim.astype(np.float64).copy()
    out = np.full(sim.shape[0], -1, np.int32)
    while sim.size and sim.max() >= thr:
        r, c = np.unravel_index(np.argmax(sim), sim.shape)
        out[r] = c
        sim[r, :] = -np.inf
        sim[:, c] = -np.inf
    return out


def _same(got, want) -> None:
    assert torch.equal(got.row_to_col.cpu(), want.row_to_col)
    assert torch.equal(got.col_to_row.cpu(), want.col_to_row)
    assert int(got.rounds) == want.rounds


# -- the CPU route ---------------------------------------------------------------
@pytest.mark.parametrize("shape", [(12, 9), (3, 12, 9), (3, 9, 12)])
@pytest.mark.parametrize("name", ["random", "ties", "nan", "below", "equal", "ocsort"])
def test_cpu_takes_the_plain_version_and_rounds_is_an_int(name, shape):
    sim, rv, cv, thr = assign_case(name, 3, shape)
    before = assignment.launches
    got = greedy_assign(sim, thr, rv, cv)
    assert assignment.launches == before
    _same(got, greedy_assign_reference(sim, thr, rv, cv))
    rounds = greedy_assign_rounds(sim, thr, rv, cv)
    assert type(rounds) is int and rounds == got.rounds
    assert 0 <= rounds <= min(shape[-2:])
    # a valid assignment: matched pairs name each other, only valid rows and
    # columns, every pair at or above the threshold
    r2c = got.row_to_col.reshape(-1, shape[-2])
    c2r = got.col_to_row.reshape(-1, shape[-1])
    for s in range(r2c.shape[0]):
        for r, c in enumerate(r2c[s].tolist()):
            if c >= 0:
                assert c2r[s, c] == r
                assert sim.reshape(-1, *shape[-2:])[s, r, c] >= np.float32(thr)


@pytest.mark.parametrize("seed", range(6))
def test_cpu_results_are_sequential_greedy_on_tie_free_matrices(seed):
    sim, _, _, thr = assign_case("random", seed, (20, 14), masks=False)
    got = greedy_assign(sim, thr)
    assert np.array_equal(got.row_to_col.numpy(), sequential_greedy(sim.numpy(), thr))
    assert got.rounds >= 1


# -- the kernel ------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the greedy-assignment kernel has no CPU mode)")
    return torch.device("cuda")


NAMES = ["random", "iou", "ties", "nan", "below", "equal", "ocsort"]
SHAPES = [(7, 40), (40, 7), (3, 10, 40), (3, 40, 10), (1, 256, 100), (64, 256, 100),
          (32, 256, 100), (16, 256, 100), (256, 100), (4, 1024, 300)]


def _on_card(dev, sim, rv, cv):
    return (sim.to(dev), None if rv is None else rv.to(dev), None if cv is None else cv.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_version(cuda_device, name, shape):
    for masks in (True, False):
        sim, rv, cv, thr = assign_case(name, sum(shape), shape, masks=masks)
        want = greedy_assign_reference(sim, thr, rv, cv)
        before = assignment.launches
        d_sim, d_rv, d_cv = _on_card(cuda_device, sim, rv, cv)
        got = greedy_assign(d_sim, thr, d_rv, d_cv)
        torch.cuda.synchronize()
        assert assignment.launches == before + 1
        assert got.row_to_col.device.type == "cuda" and got.row_to_col.dtype == torch.int32
        _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 5), (5, 0), (2, 0, 5), (2, 5, 0), (0, 5, 4)])
def test_kernel_empty_shapes(cuda_device, shape):
    sim, rv, cv, thr = assign_case("random", 0, shape)
    before = assignment.launches
    d_sim, d_rv, d_cv = _on_card(cuda_device, sim, rv, cv)
    got = greedy_assign(d_sim, thr, d_rv, d_cv)
    assert assignment.launches == before        # nothing to launch
    if len(shape) == 3 and shape[0] == 0:       # no stream (the plain loop cannot take it)
        assert got.row_to_col.shape == (0, shape[1]) and got.col_to_row.shape == (0, shape[2])
        assert int(got.rounds) == 0
    else:
        _same(got, greedy_assign_reference(sim, thr, rv, cv))


@pytest.mark.cuda
def test_kernel_rounds_is_a_device_tensor(cuda_device):
    sim, rv, cv, thr = assign_case("random", 5, (32, 256, 100))
    d_sim, d_rv, d_cv = _on_card(cuda_device, sim, rv, cv)
    got = greedy_assign(d_sim, thr, d_rv, d_cv)
    assert isinstance(got.rounds, torch.Tensor) and got.rounds.shape == ()
    assert got.rounds.dtype == torch.int32 and got.rounds.device.type == "cuda"
    rounds = greedy_assign_rounds(d_sim, thr, d_rv, d_cv)
    assert type(rounds) is int
    assert rounds == int(got.rounds) == greedy_assign_reference(sim, thr, rv, cv).rounds


@pytest.mark.cuda
def test_kernel_replays_in_a_cuda_graph(cuda_device):
    """No host read: the launch captures, and each replay gives the plain
    version's answer on the inputs copied in."""
    sim, rv, cv, thr = assign_case("iou", 7, (32, 256, 100))
    s_in, r_in, c_in = (x.clone() for x in _on_card(cuda_device, sim, rv, cv))
    greedy_assign(s_in, thr, r_in, c_in)                     # first launch outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = greedy_assign(s_in, thr, r_in, c_in)
    for seed in (8, 9):
        sim, rv, cv = assign_case("iou", seed, (32, 256, 100))[:3]
        for dst, src in zip((s_in, r_in, c_in), _on_card(cuda_device, sim, rv, cv)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _same(out, greedy_assign_reference(sim, thr, rv, cv))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    sim = torch.rand(2, 8, 5, device=cuda_device)
    with pytest.raises(ValueError):
        greedy_assign(sim[None], 0.2)                            # (1, S, R, C)
    with pytest.raises(TypeError):
        greedy_assign(sim, 0.2, row_valid=torch.ones(2, 8, dtype=torch.uint8,
                                                    device=cuda_device))
    with pytest.raises(ValueError):
        greedy_assign(sim, 0.2, row_valid=torch.ones(8, dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):
        greedy_assign(sim, 0.2, col_valid=torch.ones(2, 5, dtype=torch.bool))   # on the CPU
