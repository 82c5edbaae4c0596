"""Plain float32 reference of the YOLOv8 detector: forward, decode and NMS.

Reads the checkpoint itself (the flat ``.npz`` of flax variables:
``params/<layer>/conv/kernel`` HWIO, ``params/<layer>/bn/{scale,bias}``,
``batch_stats/<layer>/bn/{mean,var}``; the head's last 1x1 convs as
``params/head/<name>/{kernel,bias}``) and computes, with plain torch ops in
float32 and TF32 off:

  conv -> BatchNorm (running statistics, eps 1e-3, not folded) -> SiLU,
  C2f blocks, SPPF, the PAN neck and the decoupled head (Ultralytics'
  ``yolov8.yaml``), the DFL decode over every anchor, sigmoid scores, the
  confidence gate, the top ``nms_candidates`` by score, class-aware greedy
  suppression at IoU > ``iou_threshold`` and the top ``max_detections``.

The layer layout (repeats, channels) is read from the checkpoint's keys and
shapes; which layers stride by 2 and which C2f blocks add their shortcut
follow the published architecture."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

REG_MAX = 16
STRIDES = (8, 16, 32)
BN_EPS = 1e-3
CLASS_OFFSET = 7680.0


class PlainYOLOv8:
    def __init__(self, npz_path: str, device: torch.device):
        with np.load(npz_path) as z:
            flat = {k: z[k] for k in z.files}
        self.w: dict[str, torch.Tensor] = {}
        for k, v in flat.items():
            t = torch.from_numpy(np.array(v, np.float32))
            if t.ndim == 4:
                t = t.permute(3, 2, 0, 1).contiguous()     # HWIO -> OIHW
            self.w[k] = t.to(device)
        self.num_classes = int(self.w["params/head/cls0_2/bias"].shape[0])

    def _n(self, block: str) -> int:
        i = 0
        while f"params/{block}/m{i}/cv1/conv/kernel" in self.w:
            i += 1
        return i

    def conv(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        k = self.w[f"params/{name}/conv/kernel"]
        x = F.conv2d(x, k, None, stride, k.shape[-1] // 2)
        mean = self.w[f"batch_stats/{name}/bn/mean"]
        var = self.w[f"batch_stats/{name}/bn/var"]
        scale = self.w[f"params/{name}/bn/scale"]
        bias = self.w[f"params/{name}/bn/bias"]
        x = (x - mean[:, None, None]) / torch.sqrt(var + BN_EPS)[:, None, None]
        return F.silu(x * scale[:, None, None] + bias[:, None, None])

    def c2f(self, x: torch.Tensor, name: str, shortcut: bool) -> torch.Tensor:
        y = self.conv(x, f"{name}/cv1")
        parts = list(y.chunk(2, dim=1))
        for i in range(self._n(name)):
            h = self.conv(self.conv(parts[-1], f"{name}/m{i}/cv1"), f"{name}/m{i}/cv2")
            parts.append(parts[-1] + h if shortcut else h)
        return self.conv(torch.cat(parts, dim=1), f"{name}/cv2")

    def sppf(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x, "sppf/cv1")
        y1 = F.max_pool2d(x, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        y3 = F.max_pool2d(y2, 5, 1, 2)
        return self.conv(torch.cat([x, y1, y2, y3], dim=1), "sppf/cv2")

    def head_conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.conv2d(x, self.w[f"params/head/{name}/kernel"], self.w[f"params/head/{name}/bias"])

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, S, S) RGB in [0, 1] -> (box_dist (N, A, 64), cls_logits (N, A, C)),
        anchors in (level, row, column) order."""
        x = self.c2f(self.conv(self.conv(x, "stem", 2), "down1", 2), "c2f1", True)
        p3 = self.c2f(self.conv(x, "down2", 2), "c2f2", True)
        p4 = self.c2f(self.conv(p3, "down3", 2), "c2f3", True)
        p5 = self.sppf(self.c2f(self.conv(p4, "down4", 2), "c2f4", True))
        up = lambda t: F.interpolate(t, scale_factor=2.0, mode="nearest")  # noqa: E731
        n4 = self.c2f(torch.cat([up(p5), p4], 1), "neck_td4", False)
        n3 = self.c2f(torch.cat([up(n4), p3], 1), "neck_td3", False)
        n4b = self.c2f(torch.cat([self.conv(n3, "neck_dn3", 2), n4], 1), "neck_bu4", False)
        n5 = self.c2f(torch.cat([self.conv(n4b, "neck_dn4", 2), p5], 1), "neck_bu5", False)
        boxes, logits = [], []
        for i, f in enumerate((n3, n4b, n5)):
            b = self.head_conv(self.conv(self.conv(f, f"head/box{i}_0"), f"head/box{i}_1"),
                               f"box{i}_2")
            c = self.head_conv(self.conv(self.conv(f, f"head/cls{i}_0"), f"head/cls{i}_1"),
                               f"cls{i}_2")
            n = f.shape[0]
            boxes.append(b.permute(0, 2, 3, 1).reshape(n, -1, 4 * REG_MAX))
            logits.append(c.permute(0, 2, 3, 1).reshape(n, -1, self.num_classes))
        return torch.cat(boxes, 1), torch.cat(logits, 1)


def decode(box_dist: torch.Tensor, cls_logits: torch.Tensor, size: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every anchor's xyxy box in input pixels and its class scores."""
    dev = box_dist.device
    pts, strs = [], []
    for s in STRIDES:
        n = size // s
        xs = torch.arange(n, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1) * s)
        strs.append(torch.full((n * n, 1), float(s), device=dev))
    anchors, strides = torch.cat(pts), torch.cat(strs)
    n, a, _ = box_dist.shape
    dist = torch.softmax(box_dist.reshape(n, a, 4, REG_MAX), dim=-1)
    ltrb = (dist * torch.arange(REG_MAX, dtype=torch.float32, device=dev)).sum(-1) * strides
    boxes = torch.cat([anchors - ltrb[..., :2], anchors + ltrb[..., 2:]], dim=-1)
    return boxes, torch.sigmoid(cls_logits)


def pair_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) x (..., N, 4) xyxy -> (..., M, N) IoU."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + 1e-7)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Greedy suppression of (B, K) score-sorted candidates: row j is kept
    unless a kept row i < j overlaps it with IoU > ``iou_thresh``; rows of
    score 0 are never kept.  Solved as the unique fixpoint of
    ``keep[j] = not any(keep[i] and conflict[i, j])``."""
    b, k = scores.shape
    idx = torch.arange(k, device=boxes.device)
    conflict = ((idx[None, :] > idx[:, None]) & (pair_iou(boxes, boxes) > iou_thresh)
                & (scores[:, :, None] > 0))
    keep = torch.ones((b, k), dtype=torch.bool, device=boxes.device)
    for _ in range(k + 1):
        new = ~(conflict & keep[:, :, None]).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep & (scores > 0)


def detect(model: PlainYOLOv8, x: torch.Tensor, det: dict) -> dict[str, torch.Tensor]:
    """Model input -> detections in input pixels, each (B, max_det[, 4]),
    with ``valid`` marking real rows (score order, padded)."""
    size = x.shape[-1]
    boxes, scores = decode(*model.forward(x), size)
    if det.get("classes"):
        mask = torch.zeros(scores.shape[-1], dtype=torch.bool, device=x.device)
        mask[list(det["classes"])] = True
        scores = torch.where(mask, scores, 0.0)
    best, cls = scores.max(dim=-1)
    best = torch.where(best >= det["conf_threshold"], best, 0.0)
    k = min(det["nms_candidates"], best.shape[1])
    top, idx = torch.sort(best, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    cand = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    ccls = torch.gather(cls, 1, idx)
    keep = greedy_nms(cand + ccls[..., None].float() * CLASS_OFFSET, top, det["iou_threshold"])
    kept = torch.where(keep, top, -1.0)
    m = min(det["max_detections"], k)
    fs, sel = torch.sort(kept, dim=1, descending=True, stable=True)
    fs, sel = fs[:, :m], sel[:, :m]
    valid = fs > 0
    return {"boxes": torch.gather(cand, 1, sel[..., None].expand(-1, -1, 4)),
            "scores": torch.where(valid, fs, 0.0),
            "classes": torch.where(valid, torch.gather(ccls, 1, sel), -1),
            "valid": valid}
