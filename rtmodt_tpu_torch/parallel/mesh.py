"""Device mesh and ranks over several cards (port of ``rtmodt_tpu/parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` and lets XLA partition one
SPMD program over it.  The port runs one process (a *rank*) per mesh device
with ``torch.distributed``:

  * ``Mesh``: the ordered devices, the axis name ``"data"``, this process's
    rank and whether it runs inside the process group over those devices
    (``distributed``); a mesh that is not distributed is one process and
    makes no collective;
  * ``create_mesh`` (every visible card by default, as ``jax.devices()``,
    and an error where no card is visible; ``devices=`` or
    ``RTMODT_MESH_DEVICES`` take an explicit list, e.g. ``["cpu"] * 4`` or
    ``["cuda:0", "cuda:0"]``, the port's counterpart of the virtual device
    count, and the only way to a mesh of CPU ranks);
  * ``spawn(target, mesh, *args)`` starts one rank per mesh device (the
    ``spawn`` start method, a ``tcp://127.0.0.1`` rendezvous on a free port)
    and returns each rank's ``target(rank_mesh, *args)``; NCCL where every
    rank has a card of its own, gloo otherwise (CPU ranks, or ranks that
    share a card).  A rank that raises or dies fails the launcher, which
    stops the others; the process group's ``timeout`` fails a collective
    that waits on a dead peer;
  * ``init_distributed`` reads torch's own ``MASTER_ADDR`` / ``MASTER_PORT``
    / ``RANK`` / ``WORLD_SIZE`` (set by ``spawn``, or by another launcher);
  * ``shard_batch`` (this rank's contiguous slice of the leading axis) and
    ``replicate`` (a broadcast from rank 0); ``all_reduce_sum`` is the
    differentiable all-reduce the data-parallel BatchNorm uses;
  * ``create_hybrid_mesh`` / ``global_batch_spec``: the (host, data) rank
    layout ``rank = host * local + local_rank``, each rank a host-major block
    of the global batch.

Besides the device collectives, each rank keeps a gloo group for host-side
objects (``gather_objects``, ``sum_ints``, ``barrier``) when the device
group is NCCL.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import socket
import time
import traceback
from dataclasses import dataclass
from multiprocessing.connection import wait
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from rtmodt_tpu_torch.device import resolve_device

ENV_DEVICES = "RTMODT_MESH_DEVICES"   # the mesh's devices, set in each rank by ``spawn``
ENV_HOSTS = "RTMODT_MESH_HOSTS"
GROUP_TIMEOUT_S = 120.0               # a collective waiting on a dead rank fails after this

# the host-side group of this process where the device group is NCCL (one
# per process, as torch.distributed's default group is)
_object_group: Any = None


def _device(d: str | torch.device) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {str(d)!r} (cuda:N | cpu)")
    return dev


def mesh_backend(devices: Sequence[torch.device]) -> str:
    """``nccl`` where every rank has a card of its own, ``gloo`` otherwise."""
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


@dataclass(frozen=True)
class Mesh:
    """The ordered devices of a 1-D ``data`` mesh and this process's place
    in it.  ``hosts`` > 1 is the (host, data) layout of
    ``create_hybrid_mesh``: ``world / hosts`` ranks per host, host-major."""

    devices: tuple[torch.device, ...]
    axis: str = "data"
    rank: int = 0
    hosts: int = 1
    distributed: bool = False

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"mesh devices mix cpu and cuda: {self.names}")
        if self.world % self.hosts:
            raise ValueError(f"{self.world} devices do not split over {self.hosts} hosts")

    @property
    def world(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    @property
    def names(self) -> list[str]:
        return [str(d) for d in self.devices]

    @property
    def backend(self) -> str:
        return mesh_backend(self.devices)

    @property
    def local(self) -> int:
        """Ranks per host."""
        return self.world // self.hosts

    def shard(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows (equal blocks only)."""
        if n % self.world:
            raise ValueError(f"a leading axis of {n} does not split over a mesh of "
                             f"{self.world} devices; make it a multiple of {self.world}")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)


def visible_devices() -> list[torch.device]:
    """Every visible card (``jax.devices()``).  Where there is none it raises,
    as ``device.resolve_device`` does: a mesh runs on the CPU only where the
    caller names it."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def create_mesh(num_devices: int | None = None, axis: str = "data",
                devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """A mesh of the first ``num_devices`` of ``devices`` (default: the
    rank's mesh inside ``spawn`` or ``RTMODT_MESH_DEVICES``, else every
    visible card; with neither and no card it raises).  Inside a rank,
    the whole mesh is the process group's (``distributed``) and a mesh of
    one device is this rank's own card, which makes no collective."""
    env = os.environ.get(ENV_DEVICES)
    if devices is None:
        devices = env.split(",") if env else visible_devices()
    devs = tuple(_device(d) for d in devices)
    n = num_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, only {len(devs)} available")
    hosts = int(os.environ.get(ENV_HOSTS, "1")) if env else 1
    if _in_group() and env:
        rank, world = dist.get_rank(), dist.get_world_size()
        if n == world == len(devs):
            return Mesh(devs, axis, rank, hosts, distributed=True)
        if n == 1:
            return Mesh((devs[rank],), axis)
        raise ValueError(f"rank {rank} of {world} can take the whole mesh or its own device, "
                         f"not {n} devices")
    return Mesh(devs[:n], axis)


def local_mesh(device: str | torch.device, axis: str = "data") -> Mesh:
    """The one-process mesh of ``device``."""
    return Mesh((_device(device),), axis)


def create_hybrid_mesh(devices: Sequence[str | torch.device] | None = None,
                       hosts: int | None = None, axis: str = "data") -> Mesh:
    """The (host, data) layout: ``hosts`` hosts of ``world / hosts`` ranks,
    ``rank = host * local + local_rank``.  Inside a multi-host group the
    host count comes from torch's ``LOCAL_WORLD_SIZE``; one process gets a
    (1, N) layout, as the reference's single-process mesh."""
    if hosts is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
        world = dist.get_world_size() if _in_group() else 0
        hosts = world // local if local and world > local else 1
    m = create_mesh(axis=axis, devices=devices)
    return Mesh(m.devices, axis, m.rank, hosts, m.distributed)


def global_batch_spec(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch on the (host, data) layout: host
    h holds the contiguous block ``[h * batch / hosts, (h + 1) * batch /
    hosts)``, split over its ranks; with ``rank = host * local +
    local_rank`` that is the rank's own block of ``batch / world`` rows."""
    return mesh.shard(batch)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's contiguous slice of the leading axis of a tensor, or of
    every tensor of a tuple / NamedTuple, on the rank's device.  A leading
    axis that the mesh does not divide raises."""
    if isinstance(batch, torch.Tensor):
        return batch[mesh.shard(batch.shape[0])].to(mesh.device, non_blocking=True)
    parts = [shard_batch(x, mesh) for x in batch]
    return type(batch)(*parts) if hasattr(batch, "_fields") else type(batch)(parts)


@torch.no_grad()
def replicate(tensors: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor (a module's parameters and buffers, a dict or
    a list) from rank 0, in place; returns ``tensors``."""
    if not mesh.distributed:
        return tensors
    if isinstance(tensors, torch.nn.Module):
        items = list(tensors.parameters()) + list(tensors.buffers())
    elif isinstance(tensors, dict):
        items = list(tensors.values())
    else:
        items = list(tensors)
    for t in items:
        dist.broadcast(t.data, 0)
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks forward; the gradient is summed over the ranks too
    (every rank's loss part depends on the sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of the process group."""
    return _AllReduceSum.apply(x)


# -- host-side objects ------------------------------------------------------------

def object_group():
    """The group for host-side objects: the gloo group beside an NCCL
    default group, else the default group (``None``)."""
    return _object_group


def gather_objects(obj: Any, mesh: Mesh) -> list | None:
    """Every rank's ``obj`` on rank 0 (in rank order), None on the others;
    ``[obj]`` on a mesh that is not distributed."""
    if not mesh.distributed:
        return [obj]
    out = [None] * mesh.world if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=_object_group)
    return out


def broadcast_object(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's ``obj`` on every rank."""
    if not mesh.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_object_group)
    return box[0]


def sum_ints(values: Sequence[int], mesh: Mesh) -> list[int]:
    """Element-wise sum of a few host integers over the ranks."""
    if not mesh.distributed:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_object_group)
    return [int(v) for v in t.tolist()]


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        dist.barrier(group=_object_group)


# -- process groups and the launcher ------------------------------------------------

def init_distributed() -> bool:
    """Join the process group torch's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE`` describe (``spawn`` sets them in each rank).
    Returns False where none is set (one process); True once a group is up,
    world 1 included.  Safe to call twice.  The backend is the mesh's
    (``RTMODT_MESH_DEVICES``), else NCCL where every local rank has a card,
    gloo otherwise; a collective waiting on a dead rank fails after
    ``GROUP_TIMEOUT_S``."""
    global _object_group

    if _in_group():
        return True
    keys = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
    if not any(k in os.environ for k in keys):
        return False
    missing = [k for k in keys if k not in os.environ]
    if missing:
        raise RuntimeError(f"torch.distributed environment incomplete: {missing} unset")
    env = os.environ.get(ENV_DEVICES)
    if env:
        backend = mesh_backend([_device(d) for d in env.split(",")])
    else:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= local else "gloo")
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    _object_group = dist.new_group(backend="gloo") if backend == "nccl" else None
    return True


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(conn, target: Callable, rank: int, devices: list[str], axis: str, hosts: int,
               port: int, threads: int, args: tuple) -> None:
    """One rank: join the group, run ``target(mesh, *args)``, send back the
    pickled result or the traceback."""
    try:
        world = len(devices)
        os.environ.update({
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
            "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank % (world // hosts)),
            "LOCAL_WORLD_SIZE": str(world // hosts), ENV_DEVICES: ",".join(devices),
            ENV_HOSTS: str(hosts)})
        torch.set_num_threads(threads)
        dev = _device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_distributed()
        msg = ("ok", pickle.dumps(target(create_mesh(axis=axis), *args)))
    except BaseException:   # noqa: BLE001 - sent to the launcher, which raises it
        msg = ("error", traceback.format_exc())
    try:
        conn.send(msg)
    finally:
        conn.close()
        if _in_group():
            dist.destroy_process_group()


def spawn(target: Callable, mesh: Mesh, *args, timeout: float | None = None) -> list:
    """Run ``target(rank_mesh, *args)`` in one process per device of
    ``mesh`` and return the results in rank order.  ``target`` and ``args``
    are pickled (a module-level function of a module that the child can
    import); so are the results, which come back by value.  The first rank
    that raises or exits without a result fails the launcher: the others
    are stopped and its traceback is raised as ``RuntimeError``; so does
    ``timeout`` seconds without every result (``TimeoutError``).  Each rank
    runs torch at this process's intra-op thread count."""
    if mesh.distributed:
        raise RuntimeError("spawn is called from one process, not from inside a rank")
    ctx = mp.get_context("spawn")
    port = free_port()
    names = mesh.names
    threads = torch.get_num_threads()
    procs, readers = [], []
    try:
        for r in range(mesh.world):
            rd, wr = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_rank_main, name=f"rtmodt-rank-{r}",
                            args=(wr, target, r, names, mesh.axis, mesh.hosts, port, threads,
                                  args))
            p.start()
            wr.close()
            procs.append(p)
            readers.append(rd)
        results: dict[int, Any] = {}
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(results) < mesh.world:
            pending = [r for r in range(mesh.world) if r not in results]
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            ready = wait([readers[r] for r in pending] + [procs[r].sentinel for r in pending],
                         timeout=left)
            if not ready:
                raise TimeoutError(f"ranks {pending} of {mesh.world} gave no result within "
                                   f"{timeout} s")
            for r in pending:
                if readers[r] in ready or readers[r].poll():
                    try:
                        status, payload = readers[r].recv()
                    except EOFError:          # closed without a result: the rank died
                        status, payload = "died", None
                    if status == "ok":
                        results[r] = pickle.loads(payload)
                        continue
                    if status == "error":
                        raise RuntimeError(f"rank {r} of {mesh.world} failed:\n{payload}")
                elif procs[r].sentinel not in ready:
                    continue
                procs[r].join(1.0)
                raise RuntimeError(f"rank {r} of {mesh.world} exited with code "
                                   f"{procs[r].exitcode} before it returned a result")
        for p in procs:
            p.join(30.0)
        return [results[r] for r in range(mesh.world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for rd in readers:
            rd.close()
