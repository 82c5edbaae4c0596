"""The detection layer: the ``Detections`` container and the ``Detector``.

The port's copy of ``rtmodt_tpu/detection/detector.py``: the same
``Detections`` struct-of-arrays contract (xyxy f32, confidence f32, class_id
i32, class_names; empty frames give zero-length arrays) and the same
``Detector.detect(frame) -> Detections`` call.  One frame goes through the
BGR letterbox (``ops/letterbox.py``), the YOLOv8 forward, class-aware NMS
with the CUDA kernel K1 at B = 1 (``ops/nms.py``) and back to source
coordinates, all on the detector's device.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from rtmodt_tpu_torch.config.loader import DetectionConfig, PipelineConfig
from rtmodt_tpu_torch.device import resolve_device
from rtmodt_tpu_torch.models.weights import is_fused, load_into, load_params
from rtmodt_tpu_torch.models.yolov8 import YOLOv8, build_model
from rtmodt_tpu_torch.ops.letterbox import letterbox, letterbox_meta, unletterbox_boxes
from rtmodt_tpu_torch.ops.nms import NMSResult, batched_nms_from_logits
from rtmodt_tpu_torch.utils.coco_names import COCO_NAMES
from rtmodt_tpu_torch.utils.logging import logger


@dataclass
class Detections:
    """One frame's detections (struct-of-arrays, host numpy)."""

    xyxy: np.ndarray            # (N, 4) float32, source-frame pixel coords
    confidence: np.ndarray     # (N,)  float32
    class_id: np.ndarray       # (N,)  int32
    class_names: list[str] = field(default_factory=lambda: list(COCO_NAMES))

    def __len__(self) -> int:
        return int(self.xyxy.shape[0])

    def filter_classes(self, keep: list[int]) -> "Detections":
        mask = np.isin(self.class_id, np.asarray(keep, dtype=np.int32))
        return Detections(self.xyxy[mask], self.confidence[mask],
                          self.class_id[mask], self.class_names)

    @staticmethod
    def empty(class_names: list[str] | None = None) -> "Detections":
        return Detections(
            np.zeros((0, 4), np.float32),
            np.zeros((0,), np.float32),
            np.zeros((0,), np.int32),
            class_names or list(COCO_NAMES),
        )


@torch.no_grad()
def init_random_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """He-normal conv weights, zero biases, identity BN - from ``generator``."""
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            w = torch.randn(m.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.reset_parameters()
            m.reset_running_stats()


def build_float_model(cfg: DetectionConfig | PipelineConfig, device: torch.device,
                      seed: int = 0) -> YOLOv8:
    """The float32 model in eval mode on ``device``: the weights of
    ``detection.weights`` (else ``fallback_weights``; a reference ``.npz``, BN
    folded or not, or an ultralytics ``.pt`` / ``.pth``), else random weights
    from ``seed``; BN folded when ``fuse_bn``."""
    d = cfg.detection if isinstance(cfg, PipelineConfig) else cfg
    path = d.weights or d.fallback_weights
    if path:
        logger.info(f"loading weights from {path}")
        flat = load_params(path)
        if is_fused(flat) and not d.fuse_bn:
            raise ValueError(f"{path} has BN folded (e.g. a QAT checkpoint); "
                             "set detection.fuse_bn: true to load it")
        model = build_model(d.model, d.num_classes, fused=is_fused(flat))
        load_into(model, flat)
    else:
        logger.warning("no weights given - using random initialization from "
                       f"seed {seed} (detections are meaningless)")
        model = build_model(d.model, d.num_classes)
        init_random_(model, torch.Generator().manual_seed(seed))
    model.eval()
    if d.fuse_bn:
        model.fuse_bn()
    return model.to(device)


def synthetic_calib_batches(d: DetectionConfig, device: torch.device) -> list[torch.Tensor]:
    """The reference's synthetic int8 calibration: ``calib_frames`` uniform
    NHWC batches of one from ``np.random.default_rng(0)``, in the compute
    dtype."""
    rng = np.random.default_rng(0)
    s = d.input_size
    dtype = torch.bfloat16 if d.half else torch.float32
    return [torch.from_numpy(rng.random((1, s, s, 3), np.float32)).to(device, dtype)
            for _ in range(max(1, d.calib_frames))]


def deploy(model: torch.nn.Module, d: DetectionConfig, device: torch.device,
           calib_batches: list[torch.Tensor] | None = None) -> torch.nn.Module:
    """The inference model from the fused float32 ``model`` (left as it is
    under int8): int8 per ``d.quant`` / ``d.quant_scales`` (calibrated on
    ``calib_batches``, default the synthetic ones), bf16 when ``half``,
    channels_last on the card."""
    from rtmodt_tpu_torch.quant.ptq import (load_act_scales, quantize_model,
                                            quantize_with_scales)

    dtype = torch.bfloat16 if d.half else torch.float32
    if d.quant == "int8" and d.quant_scales:
        # frozen QAT scales: the deployed program computes what QAT optimized
        logger.info(f"int8 with frozen QAT scales from {d.quant_scales}")
        model = quantize_with_scales(model, load_act_scales(d.quant_scales), dtype)
    elif d.quant == "int8":
        model = quantize_model(model, calib_batches or synthetic_calib_batches(d, device),
                               dtype=dtype)
    else:
        model = model.to(dtype=dtype)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def build_detector(cfg: DetectionConfig | PipelineConfig, device: torch.device,
                   seed: int = 0) -> torch.nn.Module:
    """The inference model of a config: ``build_float_model`` then
    ``deploy``."""
    d = cfg.detection if isinstance(cfg, PipelineConfig) else cfg
    return deploy(build_float_model(d, device, seed), d, device)


class Detector:
    """YOLOv8 detector with the reference's public API, on ``device``
    (default ``"cuda"``; raises where CUDA is absent unless ``"cpu"`` is
    asked for)."""

    def __init__(self, config: DetectionConfig | dict | None = None,
                 device: str | torch.device = "cuda", warmup: bool = True,
                 warmup_shape: tuple[int, int] | None = None, seed: int = 0):
        if isinstance(config, dict):
            config = DetectionConfig(**config)
        self.cfg = config or DetectionConfig()
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if self.cfg.half else torch.float32
        self.class_names = list(COCO_NAMES)[: self.cfg.num_classes]
        base = build_float_model(self.cfg, self.device, seed)
        # int8 keeps the float32 build for calibrate() to quantize again
        self._float_model = base if self.cfg.quant == "int8" else None
        self.model = deploy(base, self.cfg, self.device)
        self._class_mask = None
        if self.cfg.classes:
            mask = torch.zeros(self.cfg.num_classes, dtype=torch.bool)
            mask[list(self.cfg.classes)] = True
            self._class_mask = mask.to(self.device)
        if warmup:
            self._warmup(warmup_shape or (640, 640))

    def calibrate(self, frames_bgr: list[np.ndarray]) -> None:
        """Re-derive the int8 activation scales from real BGR frames,
        letterboxed as inference letterboxes them, in place of the synthetic
        (or frozen) ones."""
        if self.cfg.quant != "int8":
            raise ValueError("calibrate() only applies with detection.quant=int8")
        batches = [self.preprocess(torch.as_tensor(f).to(self.device))[None]
                   for f in frames_bgr]
        d = dataclasses.replace(self.cfg, quant_scales=None)
        self.model = deploy(self._float_model, d, self.device, calib_batches=batches)

    # -- the stages of one frame (Pipeline.step times them one by one) ----
    def preprocess(self, frame: torch.Tensor) -> torch.Tensor:
        """Device uint8 ``(H, W, 3)`` BGR -> model input ``(S, S, 3)``."""
        return letterbox(frame, self.cfg.input_size, dtype=self.dtype)[0]

    @torch.no_grad()
    def forward(self, img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(S, S, 3)`` model input -> raw heads of a batch of one."""
        # NHWC storage is a channels_last NCHW tensor: no copy
        return self.model(img[None].permute(0, 3, 1, 2))

    @torch.no_grad()
    def nms_letterboxed(self, raw: tuple[torch.Tensor, torch.Tensor]) -> NMSResult:
        """Raw heads -> the frame's detections (no batch axis) in model-input
        coordinates; K1 runs once, at B = 1."""
        d = self.cfg
        res = batched_nms_from_logits(
            raw[0], raw[1], d.input_size, d.conf_threshold, d.iou_threshold,
            d.max_detections, d.nms_candidates, self._class_mask, d.agnostic_nms)
        return NMSResult(*(t[0] for t in res))

    def to_source(self, res: NMSResult, src_h: int, src_w: int) -> NMSResult:
        """Detections in model-input coordinates -> source coordinates."""
        meta = letterbox_meta(src_h, src_w, self.cfg.input_size)
        return res._replace(boxes=unletterbox_boxes(res.boxes, meta))

    def nms(self, raw: tuple[torch.Tensor, torch.Tensor], src_h: int, src_w: int
            ) -> NMSResult:
        """Raw heads -> the frame's detections (no batch axis) in source
        coordinates; K1 runs once, at B = 1."""
        return self.to_source(self.nms_letterboxed(raw), src_h, src_w)

    def detect_device(self, frame_bgr_u8: np.ndarray | torch.Tensor) -> NMSResult:
        """Detections as fixed-shape device tensors (``max_detections`` rows)."""
        frame = torch.as_tensor(frame_bgr_u8).to(self.device)
        h, w = frame.shape[:2]
        return self.nms(self.forward(self.preprocess(frame)), h, w)

    def detect(self, frame_bgr_u8: np.ndarray) -> Detections:
        """Reference-compatible API: BGR uint8 HWC in, host Detections out."""
        res = NMSResult(*(t.cpu() for t in self.detect_device(frame_bgr_u8)))
        n = int(res.count)
        return Detections(
            res.boxes[:n].numpy().astype(np.float32),
            res.scores[:n].numpy().astype(np.float32),
            res.classes[:n].numpy().astype(np.int32),
            self.class_names,
        )

    def _warmup(self, shape_hw: tuple[int, int], iters: int = 3) -> None:
        """Run the detector on zeros: cuDNN picks its algorithms and the
        allocator fills its pools before the first real frame."""
        h, w = shape_hw
        dummy = np.zeros((h, w, 3), np.uint8)
        t0 = time.perf_counter()
        for _ in range(iters):
            self.detect_device(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info(f"warmup done in {time.perf_counter() - t0:.2f}s ({w}x{h})")
