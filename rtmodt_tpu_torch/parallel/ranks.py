"""Rank targets for ``parallel.mesh.spawn`` that the tests, ``chip_smoke.py``
and the tools share.

A spawned rank imports its target's module afresh, so the targets live in a
module of the port, which imports no JAX (the test files do).  Each takes
the rank's ``Mesh`` first and returns plain data, which comes back to the
launcher by value.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from rtmodt_tpu_torch.parallel.mesh import Mesh, replicate


class GradCapture:
    """A stand-in optimizer that keeps each update's gradients (the
    all-reduced ones in a data-parallel step, before any clipping) and
    leaves the parameters as they are."""

    def __init__(self):
        self.grads: list[dict[str, torch.Tensor]] = []

    def init(self, params: dict[str, torch.Tensor]):
        from rtmodt_tpu_torch.training.train_step import OptState

        return OptState(0, {}, {})

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state, params) -> tuple[torch.Tensor, float]:
        from rtmodt_tpu_torch.training.train_step import global_norm

        self.grads.append({k: g.detach().cpu().clone() for k, g in grads.items()})
        state.count += 1
        return global_norm(grads.values()), 0.0


def _model_for(spec: dict, device: torch.device) -> torch.nn.Module:
    from rtmodt_tpu_torch.models.yolov8 import build_model

    dtype = torch.bfloat16 if spec.get("dtype") == "bfloat16" else torch.float32
    model = build_model(spec["model"], spec["num_classes"], dtype=dtype)
    model.load_state_dict(spec["state"])
    model = model.to(device)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model


def train_steps(mesh: Mesh, spec: dict) -> dict[str, Any]:
    """``len(spec["batches"])`` data-parallel steps over ``mesh`` from the
    model ``spec["model"]`` / ``num_classes`` with the ``state`` dict
    (replicated from rank 0) at ``input_size``.  Each batch is a global
    ``(images, gt_boxes, gt_labels, gt_mask)`` of numpy arrays; the rank
    takes its slice.  ``spec["optimizer"]``: ``make_optimizer`` arguments
    (``lr0``, ``lrf``, ``total``, ``warmup``, ``weight_decay``,
    ``clip_norm``), or None to read out the gradients instead of updating.
    Returns each step's metrics (floats), the rank's final model state (CPU)
    and, without an optimizer, each step's gradients."""
    from rtmodt_tpu_torch.training.train_step import (Batch, TrainState, make_optimizer,
                                                      make_schedule, make_sharded_train_step)

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    model = replicate(_model_for(spec, mesh.device), mesh)
    opt = spec.get("optimizer")
    tx = (GradCapture() if opt is None else make_optimizer(
        make_schedule(opt["lr0"], opt["lrf"], opt["total"], opt["warmup"]),
        opt.get("weight_decay", 0.0005), opt.get("clip_norm", 10.0)))
    state = TrainState(model, tx.init(dict(model.named_parameters())))
    step_fn, put_batch = make_sharded_train_step(model, tx, spec["input_size"], mesh)
    metrics = []
    for arrs in spec["batches"]:
        state, m = step_fn(state, put_batch(Batch(*(torch.from_numpy(np.asarray(a))
                                                    for a in arrs))))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"rank": mesh.rank, "metrics": metrics,
            "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            "grads": tx.grads if opt is None else None}


def multistream_chunks(mesh: Mesh, cfg, num_streams: int, chunks: list, src_hw: tuple[int, int]
                       ) -> dict[str, Any]:
    """``MultiStreamPipeline(cfg, num_streams, mesh=mesh)`` over packed
    chunks (each ``(y, u, v)`` with every stream, (T, S, ...) numpy): this
    rank's tracks and detections of each chunk on the host, its streams and
    its K1 launches (TF32 off)."""
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    msp = MultiStreamPipeline(cfg, num_streams, mesh=mesh)
    nms_kernel.launches = 0
    outs = []
    for planes in chunks:
        o, r = msp.submit_chunk_packed(planes, *src_hw)
        outs.append({"tracks": {k: v.cpu().numpy() for k, v in o._asdict().items()},
                     "detections": {k: v.cpu().numpy() for k, v in r._asdict().items()}})
    return {"rank": mesh.rank, "streams": (msp.stream_slice.start, msp.stream_slice.stop),
            "launches": nms_kernel.launches, "outs": outs}


def multistream_run(mesh: Mesh, cfg, sources: list, run_kwargs: dict) -> dict[str, Any]:
    """``MultiStreamPipeline(cfg, len(sources), mesh=mesh).run(sources,
    **run_kwargs)``: the summary (rank 0's holds every stream; None on the
    others) and this rank's K1 launches."""
    from rtmodt_tpu_torch.ops import nms_kernel
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline

    msp = MultiStreamPipeline(cfg, len(sources), mesh=mesh)
    nms_kernel.launches = 0
    summary = msp.run(sources, **run_kwargs)
    return {"rank": mesh.rank, "summary": summary, "launches": nms_kernel.launches}


def mesh_probe(mesh: Mesh, batch: torch.Tensor, fail_rank: int | None = None,
               hard: bool = False) -> dict[str, Any]:
    """The mesh's collectives on one rank: its ``shard_batch`` of
    ``batch``, ``replicate`` of a rank-dependent tensor, ``all_reduce_sum``
    of ``rank + 1`` with its gradient, ``sum_ints``, ``broadcast_object``
    and ``gather_objects``.  ``fail_rank`` raises there (``hard``: the
    process exits at once) while the others wait in an all-reduce."""
    import os

    from rtmodt_tpu_torch.parallel.mesh import (all_reduce_sum, broadcast_object,
                                                gather_objects, shard_batch, sum_ints)

    if mesh.rank == fail_rank:
        if hard:
            os._exit(3)
        raise RuntimeError(f"rank {mesh.rank} fails on purpose")
    x = torch.full((3,), float(mesh.rank + 1), requires_grad=True)
    y = all_reduce_sum(x)
    (y * (mesh.rank + 1)).sum().backward()
    return {"rank": mesh.rank, "world": mesh.world, "distributed": mesh.distributed,
            "shard": shard_batch(batch, mesh),
            "replicated": replicate([torch.full((2,), float(mesh.rank))], mesh)[0],
            "sum": y.detach(), "grad": x.grad,
            "ints": sum_ints([1, mesh.rank], mesh),
            "broadcast": broadcast_object({"from": mesh.rank}, mesh),
            "gathered": gather_objects(mesh.rank * 10, mesh)}


def plain_vs_sharded(mesh: Mesh, spec: dict) -> dict[str, Any]:
    """In a rank of a world-1 mesh: ``spec``'s steps (as ``train_steps``,
    with an optimizer) by the plain one-card step, by the data-parallel
    step over the mesh (whose all-reduces are then the identity) and by the
    plain step again, each from ``spec``'s state, with deterministic
    algorithms.  Returns each run's metrics and the largest parameter and
    BN-statistic gaps of the data-parallel run and of the repeat from the
    plain run (0.0: bit-equal)."""
    import os

    from rtmodt_tpu_torch.training.train_step import (Batch, TrainState, make_optimizer,
                                                      make_schedule, make_sharded_train_step,
                                                      train_step)

    if mesh.world != 1:
        raise ValueError("the plain step is the data-parallel one only on a mesh of one")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    opt = spec["optimizer"]
    runs = {}
    for name, m in (("plain", None), ("sharded", mesh), ("plain_again", None)):
        model = _model_for(spec, mesh.device)
        tx = make_optimizer(make_schedule(opt["lr0"], opt["lrf"], opt["total"], opt["warmup"]),
                            opt.get("weight_decay", 0.0005), opt.get("clip_norm", 10.0))
        state = TrainState(model, tx.init(dict(model.named_parameters())))
        step_fn, put_batch = make_sharded_train_step(model, tx, spec["input_size"], mesh)
        metrics = []
        for arrs in spec["batches"]:
            batch = Batch(*(torch.from_numpy(np.asarray(a)) for a in arrs))
            if m is None:
                state, mt = train_step(state, batch.to(mesh.device), tx=tx,
                                       input_size=spec["input_size"])
            else:
                state, mt = step_fn(state, put_batch(batch))
            metrics.append({k: float(v) for k, v in mt.items()})
        runs[name] = (metrics, {k: v.detach().clone() for k, v in model.state_dict().items()})

    def gap(a: dict, b: dict) -> float:
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)

    plain = runs["plain"][1]
    return {"backend": torch.distributed.get_backend(), "metrics": {k: v[0] for k, v in runs.items()},
            "gap_sharded": gap(plain, runs["sharded"][1]),
            "gap_repeat": gap(plain, runs["plain_again"][1])}
