"""The port's device mesh and ranks (``rtmodt_tpu_torch/parallel/mesh.py``),
the counterpart of ``rtmodt_tpu/parallel/mesh.py``, on CPU ranks over gloo.

``create_mesh`` defaults and errors, the backend choice, the (host, data)
layout, ``init_distributed`` without torch's environment, and on two
spawned CPU ranks ``shard_batch``, ``replicate``, the differentiable
all-reduce and the host-side collectives; a rank that raises, or dies,
fails the launcher at once and stops the other rank, which waits in a
collective.
"""

from __future__ import annotations

import time

import pytest
import torch

from rtmodt_tpu_torch.parallel import mesh as M
from rtmodt_tpu_torch.parallel.ranks import mesh_probe
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)


def test_create_mesh_defaults_and_errors(monkeypatch):
    monkeypatch.delenv(M.ENV_DEVICES, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.create_mesh()                      # no card and none named: no CPU mesh
    m = M.create_mesh(devices=["cpu"])
    assert m.devices == (torch.device("cpu"),) and m.world == 1 and m.rank == 0
    assert m.axis == "data" and not m.distributed and m.device == torch.device("cpu")
    four = M.create_mesh(devices=["cpu"] * 4)
    assert four.world == 4 and not four.distributed
    assert M.create_mesh(2, devices=["cpu"] * 4).world == 2
    with pytest.raises(ValueError, match="requested 5 devices, only 4 available"):
        M.create_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mix cpu and cuda"):
        M.create_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="unsupported mesh device"):
        M.create_mesh(devices=["meta"])
    assert M.create_mesh(devices=["cuda"]).devices == (torch.device("cuda", 0),)


def test_no_card_gives_no_cpu_mesh_unless_named(monkeypatch):
    """Where no card is visible, the default devices raise as
    ``resolve_device`` does; the CPU is a mesh device only where it is named
    (``devices=``, ``RTMODT_MESH_DEVICES``, the dry run's ``--devices``)."""
    from tools import dryrun_multichip_torch

    monkeypatch.delenv(M.ENV_DEVICES, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (M.visible_devices, M.create_mesh, lambda: M.create_mesh(2),
                 M.create_hybrid_mesh):
        with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
            make()
    with pytest.raises(SystemExit, match="dryrun_multichip_torch: .*CUDA is not available"):
        dryrun_multichip_torch.main([])
    assert M.create_mesh(devices=["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2
    monkeypatch.setenv(M.ENV_DEVICES, "cpu,cpu")
    named = M.create_mesh()
    assert named.devices == (torch.device("cpu"),) * 2 and not named.distributed


def test_backend_is_nccl_only_where_every_rank_has_its_own_card():
    dev = torch.device
    assert M.mesh_backend([dev("cuda", 0), dev("cuda", 1)]) == "nccl"
    assert M.mesh_backend([dev("cuda", 0)]) == "nccl"
    assert M.mesh_backend([dev("cuda", 0), dev("cuda", 0)]) == "gloo"
    assert M.mesh_backend([dev("cpu")] * 2) == "gloo"
    assert M.create_mesh(devices=["cuda:0", "cuda:1"]).backend == "nccl"


def test_shard_and_the_hybrid_layout():
    devs = (torch.device("cpu"),) * 4
    assert M.Mesh(devs, rank=2).shard(8) == slice(4, 6)
    with pytest.raises(ValueError, match="does not split over a mesh of 4"):
        M.Mesh(devs, rank=0).shard(6)
    hybrid = M.create_hybrid_mesh(devices=["cpu"] * 4, hosts=2)
    assert (hybrid.hosts, hybrid.local) == (2, 2)
    # rank = host * local + local_rank: each host a contiguous block of the
    # global batch, split over its ranks
    rows = [M.global_batch_spec(M.Mesh(devs, rank=r, hosts=2), 8) for r in range(4)]
    assert rows == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    for host in range(2):
        block = sorted(i for r in (2 * host, 2 * host + 1) for i in range(8)[rows[r]])
        assert block == list(range(4 * host, 4 * host + 4))
    assert M.create_hybrid_mesh(devices=["cpu"] * 2).hosts == 1     # one process: (1, N)
    with pytest.raises(ValueError, match="do not split over 3 hosts"):
        M.Mesh(devs, hosts=3)


def test_init_distributed_without_the_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert M.init_distributed() is False
    assert M.init_distributed() is False                     # safe to call twice
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="incomplete"):
        M.init_distributed()


def test_collectives_on_two_cpu_ranks():
    batch = torch.arange(8.0).reshape(4, 2)
    out = M.spawn(mesh_probe, M.create_mesh(devices=["cpu", "cpu"]), batch, timeout=120)
    assert [r["rank"] for r in out] == [0, 1]
    for r in out:
        assert r["world"] == 2 and r["distributed"]
        torch.testing.assert_close(r["shard"], batch[2 * r["rank"]:2 * r["rank"] + 2],
                                   rtol=0, atol=0)
        assert torch.equal(r["replicated"], torch.zeros(2))          # rank 0's
        assert torch.equal(r["sum"], torch.full((3,), 3.0))          # 1 + 2
        # d/dx_r of sum_r' (r' + 1) * sum(x) = 1 + 2 on every rank
        assert torch.equal(r["grad"], torch.full((3,), 3.0))
        assert r["ints"] == [2, 1]
        assert r["broadcast"] == {"from": 0}
    assert out[0]["gathered"] == [0, 10] and out[1]["gathered"] is None


def test_a_world_1_rank_is_distributed():
    out = M.spawn(mesh_probe, M.create_mesh(devices=["cpu"]), torch.ones(2, 1), timeout=120)
    assert out[0]["distributed"] and out[0]["gathered"] == [0]
    assert torch.equal(out[0]["sum"], torch.ones(3))


@pytest.mark.parametrize("hard", [False, True], ids=["raises", "dies"])
def test_a_failing_rank_fails_the_launcher(hard):
    mesh = M.create_mesh(devices=["cpu", "cpu"])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2") as err:
        M.spawn(mesh_probe, mesh, torch.ones(2, 1), 1, hard, timeout=120)
    # the other rank waits in an all-reduce; the launcher stops it at once
    assert time.monotonic() - t0 < 60
    assert ("exited with code 3" if hard else "fails on purpose") in str(err.value)


def test_spawn_is_not_called_from_a_rank():
    with pytest.raises(RuntimeError, match="not from inside a rank"):
        M.spawn(mesh_probe, M.Mesh((torch.device("cpu"),), distributed=True), None)
