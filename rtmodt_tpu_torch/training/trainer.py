"""The training loop of ``tools/train_torch.py`` (port of ``tools/train.py``).

``YoloDataset`` (mosaic augmentation, prefetch thread) -> ``train_step`` on
one card -> EMA of the parameters -> validation mAP every ``val_interval``
epochs -> checkpoints with best-by-mAP50 retention and early stopping ->
``ema_final.npz`` in the reference's ``.npz`` layout; optionally a
quantization-aware fine-tune that writes ``qat_final.npz`` and
``qat_act_scales.npz``.

  * The EMA ramps in as ``d = decay * (1 - exp(-(t + 1) / 2000))`` and
    averages the parameters only, not the BN statistics.
  * Validation runs on the EMA parameters with the current BN statistics:
    each val image is letterboxed on the card, decoded over the full grid,
    and suppressed by ``batched_nms_fixed`` (K1 at K = 1000, once per image),
    then scored by the repository's COCO evaluator at IoU 0.5.  The
    validation model runs in float32; the reference runs it in its compute
    dtype with float32 BN.
  * The port's checkpoints also hold the EMA parameters, so a resumed run
    continues the same average (the reference restarts it from the restored
    parameters).
  * Several cards: ``parallel.num_devices`` means what it means to
    ``tools/train.py`` (absent or 0: every card).  ``train`` starts one
    rank per card (``parallel/mesh.py``); each holds a ``Trainer`` with the
    rank's mesh and runs the data-parallel step (``make_sharded_train_step``)
    on its slice of the global batch.  Rank 0 alone runs the loader (the
    reference's one sequential random stream) and broadcasts each global
    batch on the device; it alone keeps the EMA, validates, checkpoints and
    writes ``ema_final.npz`` while the others wait.  One card is the
    single-card path, with no process group.
"""

from __future__ import annotations

import copy
import math
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from rtmodt_tpu_torch.parallel.mesh import (Mesh, barrier, broadcast_object, create_mesh,
                                            local_mesh, replicate, spawn)
from rtmodt_tpu_torch.utils.logging import logger

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "config")


def load_train_config(path: str | None = None, epochs: int | None = None,
                      batch_size: int | None = None, imgsz: int | None = None,
                      data_root: str | None = None, resume: bool = False) -> dict:
    """A training YAML (default the port's ``config/training.yaml``) with
    the command line's overrides, as ``tools/train.py`` applies them."""
    from rtmodt_tpu_torch.config.loader import load_yaml

    cfg = load_yaml(path or os.path.join(CONFIG_DIR, "training.yaml"))
    if epochs:
        cfg["epochs"] = epochs
    if batch_size:
        cfg["batch_size"] = batch_size
    if imgsz:
        cfg["input_size"] = imgsz
    if data_root:
        cfg["data"]["root"] = data_root
    if resume:
        cfg["checkpoint"]["resume"] = True
    return cfg


def ema_decay_at(decay: float, t: int) -> float:
    """The EMA's decay after update ``t`` (0-based)."""
    return decay * (1.0 - math.exp(-(t + 1) / 2000.0))


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], params: dict[str, torch.Tensor], d: float) -> None:
    """``e = d * e + (1 - d) * p`` in float32, ``1 - d`` taken in float32
    as the reference's jitted update takes it."""
    d32 = np.float32(d)
    one_minus = float(np.float32(1.0) - d32)
    for k, e in ema.items():
        e.copy_(float(d32) * e + one_minus * params[k].detach())


def train_devices(cfg: dict, device: str = "cuda") -> list[str]:
    """The devices ``parallel.num_devices`` asks for: on the card, that many
    of the visible cards (absent or 0: all; at most all, as
    ``tools/train.py``); on the CPU that many CPU ranks (default one)."""
    from rtmodt_tpu_torch.device import resolve_device

    n = int((cfg.get("parallel") or {}).get("num_devices") or 0)
    if resolve_device(device).type == "cpu":
        return ["cpu"] * max(1, n)
    count = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(min(n or count, count))]


def train(cfg: dict, device: str = "cuda", weights: str | None = None,
          max_steps: int | None = None, qat_steps: int = 0,
          compare_raw: bool = False) -> dict[str, Any]:
    """Train ``cfg`` on the devices of ``train_devices``: one card in this
    process, several in one rank each.  ``qat_steps`` > 0 then runs the
    quantization-aware fine-tune (on rank 0).  Returns ``fit``'s summary
    (rank 0's), with ``qat`` holding the QAT files."""
    devices = train_devices(cfg, device)
    if len(devices) == 1:
        return _train_on(None, cfg, device, weights, max_steps, qat_steps, compare_raw)
    return spawn(_train_on, create_mesh(devices=devices), cfg, device, weights, max_steps,
                 qat_steps, compare_raw)[0]


def _train_on(mesh: Mesh | None, cfg: dict, device: str, weights: str | None,
              max_steps: int | None, qat_steps: int, compare_raw: bool) -> dict[str, Any]:
    trainer = Trainer(cfg, device, weights, mesh=mesh)
    out = trainer.fit(max_steps, compare_raw=compare_raw)
    if qat_steps > 0 and trainer.lead:
        out["qat"] = trainer.qat(qat_steps)
    return out


class Trainer:
    """One training run of a config on ``device``, or in one rank of
    ``mesh`` (its device).  ``weights`` (a reference ``.npz``, BN unfused)
    starts the model from trained weights; without it the model gets the
    from-scratch init (seed 0).  A resumed run (``checkpoint.resume``)
    restores the latest checkpoint over either."""

    def __init__(self, cfg: dict, device: str | torch.device = "cuda",
                 weights: str | None = None, mesh: Mesh | None = None):
        from rtmodt_tpu_torch.config.loader import is_rtdetr
        from rtmodt_tpu_torch.device import resolve_device
        from rtmodt_tpu_torch.models.weights import load_npz
        from rtmodt_tpu_torch.models.yolov8 import build_model
        from rtmodt_tpu_torch.training.checkpoint import CheckpointManager, load_train_state
        from rtmodt_tpu_torch.training.data import AugConfig, YoloDataset
        from rtmodt_tpu_torch.training.train_step import (create_train_state,
                                                          make_optimizer, make_schedule)

        if is_rtdetr(cfg["model"]):
            raise ValueError(f"training (and QAT) covers YOLOv8 only; {cfg['model']} has "
                             "no loss, assigner or denoising queries in the port")
        n_dev = int((cfg.get("parallel") or {}).get("num_devices") or 0)
        if mesh is None and n_dev > 1:
            raise ValueError(f"parallel.num_devices: {n_dev} trains in {n_dev} ranks, one per "
                             "card: start them with trainer.train (tools/train_torch.py), "
                             "or pass each rank's mesh")
        self.cfg = cfg
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.mesh = mesh or local_mesh(self.device)
        self.lead = self.mesh.rank == 0     # the loader, EMA, validation and checkpoints
        self.size = int(cfg["input_size"])
        self.batch_size = int(cfg["batch_size"])
        self.mesh.shard(self.batch_size)    # a global batch the mesh does not divide raises
        dtype = torch.bfloat16 if cfg.get("precision", "bf16") == "bf16" else torch.float32
        self.model = build_model(cfg["model"], cfg["num_classes"], dtype=dtype).to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)

        aug = AugConfig(**cfg.get("augmentation", {}))
        self.dataset = YoloDataset(cfg["data"]["root"], cfg["data"]["train_split"], self.size,
                                   cfg["data"]["max_boxes"], augment=True, aug=aug)
        self.steps_per_epoch = (cfg.get("steps_per_epoch")
                                or max(1, len(self.dataset) // self.batch_size))
        self.total_steps = self.steps_per_epoch * cfg["epochs"]
        warmup_steps = self.steps_per_epoch * cfg["optimizer"]["warmup_epochs"]
        opt = cfg["optimizer"]
        self.schedule = make_schedule(opt["lr0"], opt["lrf"], self.total_steps, warmup_steps)
        self.tx = make_optimizer(self.schedule, opt["weight_decay"], opt["clip_norm"])
        self.state = create_train_state(self.model, self.tx,
                                        init_variables=load_npz(weights) if weights else None)
        self.ema_decay = float(cfg.get("ema_decay", 0.0))
        self.ema = ({k: p.detach().clone() for k, p in self.state.params().items()}
                    if self.ema_decay and self.lead else None)
        self.ckpt = CheckpointManager(cfg["checkpoint"]["dir"])
        if cfg["checkpoint"].get("resume") and self.ckpt.latest_step is not None:
            ema = load_train_state(self.state, self.ckpt.restore())
            if self.ema is not None and ema is not None:
                self.ema = ema
            logger.info(f"resumed from step {self.state.step}")
        replicate(self.model, self.mesh)
        self._eval_model: torch.nn.Module | None = None
        where = (f"rank {self.mesh.rank} of {self.mesh.world} ({self.device})"
                 if self.mesh.world > 1 else str(self.device))
        logger.info(f"training {cfg['model']} on {where}, {self.steps_per_epoch} "
                    f"steps/epoch x {cfg['epochs']} epochs")

    # -- one step ----------------------------------------------------------
    def step(self, batch) -> dict[str, Any]:
        """One train step on a host ``Batch`` (moved to the card here) and
        the EMA update.  Over several ranks ``batch`` is rank 0's global
        batch (None on the others): it is broadcast and each rank steps on
        its slice."""
        from rtmodt_tpu_torch.training.train_step import train_step

        loss = self.cfg["loss"]
        t = self.state.step
        batch = self._share(batch) if self.mesh.distributed else batch.to(self.device)
        _, metrics = train_step(self.state, batch, tx=self.tx,
                                input_size=self.size, box_gain=loss["box"],
                                cls_gain=loss["cls"], dfl_gain=loss["dfl"], mesh=self.mesh)
        if self.ema is not None:
            ema_update(self.ema, self.state.params(), ema_decay_at(self.ema_decay, t))
        return metrics

    def _share(self, batch):
        """Rank 0's global batch on every rank's device (two broadcasts:
        the uint8 images, and boxes, labels and mask as one float32 tensor),
        then this rank's slice."""
        import torch.distributed as dist

        from rtmodt_tpu_torch.training.train_step import Batch

        b, s, m = self.batch_size, self.size, int(self.cfg["data"]["max_boxes"])
        if self.lead:
            images = batch.images.to(self.device, non_blocking=True)
            gt = torch.cat([batch.gt_boxes.float(), batch.gt_labels[..., None].float(),
                            batch.gt_mask[..., None].float()], dim=-1).to(self.device)
        else:
            images = torch.empty((b, s, s, 3), dtype=torch.uint8, device=self.device)
            gt = torch.empty((b, m, 6), dtype=torch.float32, device=self.device)
        dist.broadcast(images, 0)
        dist.broadcast(gt, 0)
        rows = self.mesh.shard(b)
        gt = gt[rows]
        return Batch(images[rows], gt[..., :4].contiguous(), gt[..., 4].to(torch.int32),
                     gt[..., 5] > 0.5)

    # -- validation --------------------------------------------------------
    def eval_model(self, raw: bool = False) -> torch.nn.Module:
        """A float32 eval copy holding the EMA (or, ``raw``, the live)
        parameters and the current BN statistics."""
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(self.model).float().eval()
            self._eval_model.dtype = torch.float32
        m = self._eval_model
        with torch.no_grad():
            m.load_state_dict(self.model.state_dict())
            if self.ema is not None and not raw:
                own = dict(m.named_parameters())
                for k, v in self.ema.items():
                    own[k].copy_(v)
        return m

    @torch.no_grad()
    def validate(self, raw: bool = False) -> dict[str, float] | None:
        """Val mAP over the dataset's COCO GT (None when it has none)."""
        import json

        import cv2

        from rtmodt_tpu_torch.evaluation.coco_eval import COCODetEval
        from rtmodt_tpu_torch.models.yolov8 import decode_predictions
        from rtmodt_tpu_torch.ops.letterbox import letterbox, unletterbox_boxes
        from rtmodt_tpu_torch.ops.nms import batched_nms_fixed

        root = self.cfg["data"]["root"]
        gt_json = os.path.join(root, "val_coco_gt.json")
        val_dir = os.path.join(root, "images", self.cfg["data"]["val_split"])
        if not (os.path.exists(gt_json) and os.path.isdir(val_dir)):
            logger.info("no val GT json found; skipping val mAP")
            return None
        model = self.eval_model(raw)
        s = self.size
        with open(gt_json) as f:
            gt = json.load(f)
        preds = []
        for im in gt["images"]:
            frame = cv2.imread(os.path.join(val_dir, im["file_name"]))
            if frame is None:
                continue
            img, meta = letterbox(torch.from_numpy(frame).to(self.device), s,
                                  dtype=torch.float32)
            bd, cl = model(img.permute(2, 0, 1)[None])
            boxes, scores = decode_predictions(bd, cl, s)
            r = batched_nms_fixed(boxes[0], scores[0], 0.001, 0.6, 300, 1000)
            n = int(r.count)
            out_boxes = unletterbox_boxes(r.boxes[:n], meta).cpu().numpy()
            out_scores = r.scores[:n].cpu().numpy()
            out_classes = r.classes[:n].cpu().numpy()
            for i in range(n):
                x1, y1, x2, y2 = (float(v) for v in out_boxes[i])
                preds.append({"image_id": im["id"], "category_id": int(out_classes[i]) + 1,
                              "bbox": [x1, y1, x2 - x1, y2 - y1],
                              "score": float(out_scores[i])})
        result = COCODetEval(gt, preds).evaluate(0.5)
        logger.info(f"val @ step {self.state.step}: mAP50={result['mAP_50']:.4f} "
                    f"recall={result['recall']:.4f}")
        return result

    # -- checkpoints -----------------------------------------------------------
    def save(self, metrics: dict[str, float] | None = None) -> str | None:
        """Checkpoint the current step (a step already saved is kept, as
        orbax keeps it); returns the file written, or None."""
        from rtmodt_tpu_torch.training.checkpoint import train_state_dict

        if self.state.step in self.ckpt.all_steps():
            return None
        return self.ckpt.save(self.state.step, train_state_dict(self.state, self.ema), metrics)

    def save_ema_final(self) -> str:
        """``ema_final.npz``: the EMA parameters with the current BN
        statistics, in the layout the JAX ``Detector`` and the port's load."""
        from rtmodt_tpu_torch.models.weights import save_npz

        path = os.path.join(self.cfg["checkpoint"]["dir"], "ema_final.npz")
        save_npz(self.eval_model(), path)
        return path

    # -- the loop ----------------------------------------------------------------
    def fit(self, max_steps: int | None = None, compare_raw: bool = False,
            on_step: Callable[[int, dict], None] | None = None) -> dict[str, Any]:
        """The reference's loop.  ``on_step(step, metrics)`` sees each
        step's metrics, still on the card (reading one waits for the step),
        with ``wait_ms``, the host's wait for the batch.  The summary holds
        each step's ``wait_ms`` and ``step_ms`` (the step and EMA on the
        card's clock, CUDA events; the host clock on the CPU).  The events
        are read at the logging steps and at the end, so the loop waits for
        the card only to log, validate and save."""
        cfg = self.cfg
        val_every = self.steps_per_epoch * max(1, int(cfg.get("val_interval", 1)))
        save_every = self.steps_per_epoch * cfg["checkpoint"]["save_period"]
        patience = int(cfg.get("patience", 0))
        best_map, no_improve, vals = -1.0, 0, []
        cuda = self.device.type == "cuda"
        waits: list[float] = []
        step_ms: list[float] = []
        events: list = []

        def read_events() -> None:
            if events:
                events[-1][1].synchronize()
                step_ms.extend(e0.elapsed_time(e1) for e0, e1 in events)
                events.clear()

        t0 = time.perf_counter()
        batches = self.dataset.batches(self.batch_size, pin=cuda) if self.lead else None
        try:
            while True:
                tw = time.perf_counter()
                batch = next(batches) if batches is not None else None
                wait_ms = (time.perf_counter() - tw) * 1e3
                waits.append(wait_ms)
                if cuda:
                    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    ev[0].record()
                else:
                    ts = time.perf_counter()
                metrics = self.step(batch)
                if cuda:
                    ev[1].record()
                    events.append(ev)
                else:
                    step_ms.append((time.perf_counter() - ts) * 1e3)
                gstep = self.state.step
                if on_step is not None:
                    on_step(gstep, {**metrics, "wait_ms": wait_ms})
                if gstep % 50 == 0 and self.lead:
                    read_events()
                    m = {k: float(v) for k, v in metrics.items()}
                    rate = self.batch_size * 50 / (time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    logger.info(f"step {gstep}/{self.total_steps} loss={m['loss']:.3f} "
                                f"box={m['box_loss']:.3f} cls={m['cls_loss']:.3f} "
                                f"dfl={m['dfl_loss']:.3f} fg={int(m['num_fg'])} "
                                f"{rate:.1f} img/s")
                if gstep % val_every == 0:
                    stop = False
                    r = self.validate() if self.lead else None
                    if compare_raw and self.ema is not None and r is not None:
                        raw = self.validate(raw=True)
                        logger.info(f"val @ step {gstep}: EMA mAP50={r['mAP_50']:.4f} vs raw "
                                    f"mAP50={raw['mAP_50']:.4f} "
                                    f"(delta {r['mAP_50'] - raw['mAP_50']:+.4f})")
                    if r is not None:
                        vals.append((gstep, r["mAP_50"]))
                        if r["mAP_50"] > best_map:
                            best_map, no_improve = r["mAP_50"], 0
                        else:
                            no_improve += 1
                        self.save({"map50": r["mAP_50"]})
                        if patience and no_improve >= patience:
                            logger.info(f"early stop: no val improvement for {patience} evals")
                            stop = True
                    if broadcast_object(stop, self.mesh):   # the other ranks wait here
                        break
                elif gstep % save_every == 0:
                    if self.lead:
                        self.save()
                    barrier(self.mesh)
                if max_steps and gstep >= max_steps:
                    logger.info("max-steps reached")
                    break
                if gstep >= self.total_steps:
                    break
        except KeyboardInterrupt:
            logger.info("interrupted")
        finally:
            if batches is not None:
                batches.close()
        read_events()
        ema_path = None
        if self.lead:
            self.save()
            ema_path = self.save_ema_final() if self.ema is not None else None
        barrier(self.mesh)
        self.ckpt.close()
        logger.info(f"training done at step {self.state.step} (best mAP50={best_map:.4f})")
        return {"step": self.state.step, "best_map50": best_map, "vals": vals,
                "ema_final": ema_path, "wait_ms": waits, "step_ms": step_ms}

    # -- quantization-aware fine-tune ------------------------------------------
    def qat(self, steps: int) -> tuple[str, str]:
        """Fold BN into the EMA (or live) parameters and fine-tune ``steps``
        steps through int8 rounding with frozen activation scales; writes
        ``qat_final.npz`` and ``qat_act_scales.npz`` (``|`` for ``/`` in
        its keys) beside the checkpoints.  Returns their paths."""
        from rtmodt_tpu_torch.models.weights import save_npz
        from rtmodt_tpu_torch.quant.qat import qat_finetune

        fused = copy.deepcopy(self.eval_model()).fuse_bn()
        qat_lr = float(self.cfg.get("qat_lr", self.cfg["optimizer"]["lr0"] * 0.01))
        gen = self.dataset.batches(self.batch_size)
        try:
            new_fused, scales = qat_finetune(fused, (b.to(self.device) for b in gen),
                                             self.size, steps=steps, lr=qat_lr)
        finally:
            gen.close()
        out_dir = self.cfg["checkpoint"]["dir"]
        out = os.path.join(out_dir, "qat_final.npz")
        save_npz(new_fused, out)
        scales_path = os.path.join(out_dir, "qat_act_scales.npz")
        np.savez(scales_path, **{k.replace("/", "|"): np.float32(v) for k, v in scales.items()})
        logger.info(f"QAT checkpoint saved: {out} (+ qat_act_scales.npz)")
        return out, scales_path
