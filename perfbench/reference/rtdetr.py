"""Plain float32 reference of the RT-DETR-L detector: forward and output rule.

Reads the weights itself: an ``.npz`` keyed by Ultralytics' state-dict names
(``model.<layer>.<module>...``, conv kernels OIHW, BN ``weight``, ``bias``,
``running_mean``, ``running_var``), and computes with plain torch ops in
float32, TF32 off (set when a model is built), Ultralytics' ``rtdetr-l.yaml``
inference:

  conv -> BatchNorm (running statistics, eps 1e-3, not folded) -> ReLU,
  SiLU or nothing; HGStem, HGBlocks (LightConv = 1x1 then depthwise kxk),
  depthwise stride-2 convs; the 1x1 input projections, AIFI (post-norm
  attention over P5 with Ultralytics' 2-D sin-cos positions on q and k,
  GELU FFN), the CCFM paths of RepC3 (RepConv: SiLU(3x3 BN + 1x1 BN));
  RTDETRDecoder: per-level 1x1 conv + BN, flattened, anchors in logit space
  masked outside (0.01, 0.99), ``enc_output``, class scores, the top
  ``num_queries`` anchors by best class logit, reference boxes; then each
  decoder layer (self-attention with the query position MLP on q and k,
  norm, multi-scale deformable attention through ``grid_sample`` per level,
  norm, ReLU FFN, norm, box refinement); the last layer's class logits.

The output rule (Ultralytics' ``RTDETRPredictor.postprocess``): per query the
best class probability and its index, kept above ``conf_threshold`` (and in
``classes`` where given), boxes cxcywh -> xyxy.  Departures from
Ultralytics, the program's as well:

  * the model input is the letterboxed frame (``reference/pack.py``), not
    ``LetterBox(scale_fill=True)``'s stretched one, and boxes are given in
    model-input pixels;
  * the kept queries are cut to the top ``max_detections`` by score (ties in
    query order) and padded, the tracker's fixed row count;
  * anchors whose centre lies outside (0.01, 0.99) of the letterbox's content
    box are masked as Ultralytics masks those near the image's border (the
    padding holds no image).

The layer widths come from the weights' shapes; what shapes cannot tell (the
attention heads, the queries, the letterbox's content box) comes from the
configuration file (``num_heads``, ``aifi_heads``, ``num_queries``, the
camera).  Imports torch and numpy only."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
LN_EPS = 1e-5
DECODER = "model.28"
SHORTCUT_BLOCKS = (6, 7)      # rtdetr-l.yaml: the stage-3 HGBlocks with shortcut=True


class PlainRTDETR:
    def __init__(self, npz_path: str, device: torch.device, num_heads: int, aifi_heads: int,
                 num_queries: int, content: tuple[float, float, float, float] = (0, 0, 1, 1)):
        """``content``: the letterbox's content box (x0, y0, x1, y1) as
        fractions of the input."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with np.load(npz_path) as z:
            self.w = {k: torch.from_numpy(np.array(z[k], np.float32)).to(device)
                      for k in z.files}
        self.heads, self.aifi_heads, self.num_queries = num_heads, aifi_heads, num_queries
        self.content = content
        self.levels = sum(1 for k in self.w if k.startswith(f"{DECODER}.input_proj.")
                          and k.endswith(".0.weight"))
        self.num_layers = sum(1 for k in self.w if k.startswith(f"{DECODER}.dec_score_head.")
                              and k.endswith(".weight"))
        off = self.w[f"{DECODER}.decoder.layers.0.cross_attn.sampling_offsets.weight"]
        self.points = off.shape[0] // (2 * num_heads * self.levels)

    # -- convolutions ---------------------------------------------------------
    def conv(self, x: torch.Tensor, name: str, stride: int = 1, pad: int | None = None,
             act: str | None = "silu") -> torch.Tensor:
        k = self.w[f"{name}.conv.weight"]
        groups = x.shape[1] // k.shape[1]
        x = F.conv2d(x, k, None, stride, k.shape[-1] // 2 if pad is None else pad,
                     groups=groups)
        x = self.bn(x, f"{name}.bn")
        if act == "relu":
            return F.relu(x)
        if act == "silu":
            return F.silu(x)
        return x

    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        mean, var = self.w[f"{name}.running_mean"], self.w[f"{name}.running_var"]
        g, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        x = (x - mean[:, None, None]) / torch.sqrt(var + BN_EPS)[:, None, None]
        return x * g[:, None, None] + b[:, None, None]

    def hgstem(self, x: torch.Tensor, name: str) -> torch.Tensor:
        x = self.conv(x, f"{name}.stem1", 2, act="relu")
        x = F.pad(x, [0, 1, 0, 1])
        x2 = self.conv(F.pad(self.conv(x, f"{name}.stem2a", 1, 0, "relu"), [0, 1, 0, 1]),
                       f"{name}.stem2b", 1, 0, "relu")
        x1 = F.max_pool2d(x, kernel_size=2, stride=1, padding=0, ceil_mode=True)
        x = self.conv(torch.cat([x1, x2], 1), f"{name}.stem3", 2, act="relu")
        return self.conv(x, f"{name}.stem4", act="relu")

    def hgblock(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        name = f"model.{layer}"
        ys = [x]
        i = 0
        while f"{name}.m.{i}.conv.weight" in self.w or f"{name}.m.{i}.conv1.conv.weight" in self.w:
            if f"{name}.m.{i}.conv1.conv.weight" in self.w:       # LightConv
                y = self.conv(ys[-1], f"{name}.m.{i}.conv1", act=None)
                ys.append(self.conv(y, f"{name}.m.{i}.conv2", act="relu"))
            else:
                ys.append(self.conv(ys[-1], f"{name}.m.{i}", act="relu"))
            i += 1
        y = self.conv(self.conv(torch.cat(ys, 1), f"{name}.sc", act="relu"), f"{name}.ec",
                      act="relu")
        return y + x if layer in SHORTCUT_BLOCKS and y.shape == x.shape else y

    def repc3(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = self.conv(x, f"{name}.cv1")
        i = 0
        while f"{name}.m.{i}.conv1.conv.weight" in self.w:
            y = F.silu(self.conv(y, f"{name}.m.{i}.conv1", 1, 1, None)
                       + self.conv(y, f"{name}.m.{i}.conv2", 1, 0, None))
            i += 1
        return y + self.conv(x, f"{name}.cv2")

    # -- attention ---------------------------------------------------------------
    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x @ self.w[f"{name}.weight"].T + self.w[f"{name}.bias"]

    def layer_norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + LN_EPS) * self.w[f"{name}.weight"] + \
            self.w[f"{name}.bias"]

    def mlp(self, x: torch.Tensor, name: str) -> torch.Tensor:
        i = 0
        while f"{name}.layers.{i + 1}.weight" in self.w:
            x = F.relu(self.linear(x, f"{name}.layers.{i}"))
            i += 1
        return self.linear(x, f"{name}.layers.{i}")

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str,
                  heads: int) -> torch.Tensor:
        wi, bi = self.w[f"{name}.in_proj_weight"], self.w[f"{name}.in_proj_bias"]
        d = q.shape[-1]
        dh = d // heads

        def split(x, i):
            y = x @ wi[i * d:(i + 1) * d].T + bi[i * d:(i + 1) * d]
            return y.reshape(x.shape[0], x.shape[1], heads, dh).permute(0, 2, 1, 3)

        a = torch.softmax(split(q, 0) @ split(k, 1).transpose(-1, -2) / math.sqrt(dh), dim=-1)
        o = (a @ split(v, 2)).permute(0, 2, 1, 3).reshape(q.shape)
        return self.linear(o, f"{name}.out_proj")

    def aifi(self, x: torch.Tensor, name: str) -> torch.Tensor:
        n, c, h, w = x.shape
        # Ultralytics' build_2d_sincos_position_embedding(w, h, c)
        gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32),
                                torch.arange(h, dtype=torch.float32), indexing="ij")
        pos_dim = c // 4
        omega = 1.0 / (10000.0 ** (torch.arange(pos_dim, dtype=torch.float32) / pos_dim))
        ow = gw.flatten()[..., None] @ omega[None]
        oh = gh.flatten()[..., None] @ omega[None]
        pos = torch.cat([ow.sin(), ow.cos(), oh.sin(), oh.cos()], 1)[None].to(x.device)
        src = x.flatten(2).permute(0, 2, 1)
        qk = src + pos
        src = self.layer_norm(src + self.attention(qk, qk, src, f"{name}.ma", self.aifi_heads),
                              f"{name}.norm1")
        ffn = self.linear(F.gelu(self.linear(src, f"{name}.fc1")), f"{name}.fc2")
        src = self.layer_norm(src + ffn, f"{name}.norm2")
        return src.permute(0, 2, 1).reshape(n, c, h, w)

    def deformable(self, query: torch.Tensor, ref: torch.Tensor, value: torch.Tensor,
                   shapes: list[tuple[int, int]], name: str) -> torch.Tensor:
        bs, nq, d = query.shape
        nh, nl, npnt = self.heads, self.levels, self.points
        v = self.linear(value, f"{name}.value_proj").view(bs, value.shape[1], nh, d // nh)
        off = self.linear(query, f"{name}.sampling_offsets").view(bs, nq, nh, nl, npnt, 2)
        aw = self.linear(query, f"{name}.attention_weights").view(bs, nq, nh, nl * npnt)
        aw = torch.softmax(aw, -1).view(bs, nq, nh, nl, npnt)
        r = ref[:, :, None, None, None, :]
        loc = r[..., :2] + off / npnt * r[..., 2:] * 0.5
        # Ultralytics' multi_scale_deformable_attn_pytorch
        grids = 2 * loc - 1
        maps = v.split([h * w for h, w in shapes], dim=1)
        sampled = []
        for lvl, (h, w) in enumerate(shapes):
            m = maps[lvl].flatten(2).transpose(1, 2).reshape(bs * nh, d // nh, h, w)
            g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
            sampled.append(F.grid_sample(m, g, mode="bilinear", padding_mode="zeros",
                                         align_corners=False))
        aw = aw.transpose(1, 2).reshape(bs * nh, 1, nq, nl * npnt)
        out = (torch.stack(sampled, dim=-2).flatten(-2) * aw).sum(-1).view(bs, d, nq)
        return self.linear(out.transpose(1, 2), f"{name}.output_proj")

    # -- the model -----------------------------------------------------------------
    @torch.no_grad()
    def forward(self, x: torch.Tensor, keep: dict | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, 3, S, S) RGB in [0, 1] -> (boxes (N, Q, 4) cxcywh in [0, 1],
        logits (N, Q, nc)) of the last decoder layer; ``keep`` receives the
        encoder's features (``features``, ``enc_output`` over every anchor) and
        scores (``enc_scores``), the selected anchors (``topk``) and every
        layer's (boxes, logits) (``layers``)."""
        x = self.hgblock(self.hgstem(x, "model.0"), 1)
        p3 = self.hgblock(self.conv(x, "model.2", 2, act=None), 3)
        x = self.hgblock(self.conv(p3, "model.4", 2, act=None), 5)
        p4 = self.hgblock(self.hgblock(x, 6), 7)
        p5 = self.hgblock(self.conv(p4, "model.8", 2, act=None), 9)
        up = lambda t: F.interpolate(t, scale_factor=2.0, mode="nearest")  # noqa: E731
        y12 = self.conv(self.aifi(self.conv(p5, "model.10", act=None), "model.11"), "model.12")
        y17 = self.conv(self.repc3(torch.cat([up(y12), self.conv(p4, "model.14", act=None)], 1),
                                   "model.16"), "model.17")
        x3 = self.repc3(torch.cat([up(y17), self.conv(p3, "model.19", act=None)], 1), "model.21")
        f4 = self.repc3(torch.cat([self.conv(x3, "model.22", 2), y17], 1), "model.24")
        f5 = self.repc3(torch.cat([self.conv(f4, "model.25", 2), y12], 1), "model.27")
        return self.decoder([x3, f4, f5], self.num_queries, keep)

    def decoder(self, feats: list[torch.Tensor], nq: int, keep: dict | None):
        dn = DECODER
        maps = []
        for i, f in enumerate(feats):
            y = F.conv2d(f, self.w[f"{dn}.input_proj.{i}.0.weight"])
            maps.append(self.bn(y, f"{dn}.input_proj.{i}.1"))
        shapes = [(m.shape[2], m.shape[3]) for m in maps]
        value = torch.cat([m.flatten(2).permute(0, 2, 1) for m in maps], 1)
        bs, dev = value.shape[0], value.device
        anchors = []
        for i, (h, w) in enumerate(shapes):
            gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                    torch.arange(w, dtype=torch.float32, device=dev),
                                    indexing="ij")
            xy = (torch.stack([gx, gy], -1)[None] + 0.5) / torch.tensor(
                [w, h], dtype=torch.float32, device=dev)
            wh = torch.ones_like(xy) * 0.05 * (2.0 ** i)
            anchors.append(torch.cat([xy, wh], -1).view(-1, h * w, 4))
        anchors = torch.cat(anchors, 1)
        x0, y0, x1, y1 = self.content
        rel = torch.stack([(anchors[..., 0] - x0) / (x1 - x0),
                           (anchors[..., 1] - y0) / (y1 - y0)], -1)
        valid = (((anchors > 0.01) & (anchors < 0.99)).all(-1, keepdim=True)
                 & ((rel > 0.01) & (rel < 0.99)).all(-1, keepdim=True))
        anchors = torch.log(anchors / (1 - anchors)).masked_fill(~valid, float("inf"))
        features = self.layer_norm(self.linear(valid * value, f"{dn}.enc_output.0"),
                                   f"{dn}.enc_output.1")
        scores = self.linear(features, f"{dn}.enc_score_head")
        topk = torch.topk(scores.max(-1).values, nq, dim=1).indices
        bi = torch.arange(bs, device=dev)[:, None]
        embed = features[bi, topk]
        ref = (self.mlp(embed, f"{dn}.enc_bbox_head") + anchors[0][topk]).sigmoid()
        if keep is not None:
            keep.update(features=features, enc_scores=scores, topk=topk, layers=[])
        logits = None
        for i in range(self.num_layers):
            name = f"{dn}.decoder.layers.{i}"
            pos = self.mlp(ref, f"{dn}.query_pos_head")
            qk = embed + pos
            embed = self.layer_norm(embed + self.attention(qk, qk, embed, f"{name}.self_attn",
                                                           self.heads), f"{name}.norm1")
            embed = self.layer_norm(embed + self.deformable(embed + pos, ref, value, shapes,
                                                            f"{name}.cross_attn"),
                                    f"{name}.norm2")
            ffn = self.linear(F.relu(self.linear(embed, f"{name}.linear1")), f"{name}.linear2")
            embed = self.layer_norm(embed + ffn, f"{name}.norm3")
            xs = ref.clamp(0.0, 1.0)
            inv = torch.log(xs.clamp(min=1e-5) / (1 - xs).clamp(min=1e-5))
            ref = torch.sigmoid(self.mlp(embed, f"{dn}.dec_bbox_head.{i}") + inv)
            if keep is not None or i == self.num_layers - 1:
                logits = self.linear(embed, f"{dn}.dec_score_head.{i}")
                if keep is not None:
                    keep["layers"].append((ref, logits))
        return ref, logits


def outputs(boxes: torch.Tensor, logits: torch.Tensor, size: int, det: dict
            ) -> dict[str, torch.Tensor]:
    """The output rule over (N, Q, 4) cxcywh boxes and (N, Q, nc) logits ->
    detections in model-input pixels, each (N, max_det[, 4]), ``valid``
    marking real rows (score order, padded)."""
    score, cls = torch.sigmoid(logits).max(-1)
    keep = score > det["conf_threshold"]
    if det.get("classes"):
        keep &= torch.isin(cls, torch.tensor(list(det["classes"]), device=cls.device))
    n, q = score.shape
    m = min(det["max_detections"], q)
    top, sel = torch.sort(torch.where(keep, score, -1.0), dim=1, descending=True, stable=True)
    top, sel = top[:, :m], sel[:, :m]
    valid = top > 0
    b = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4)) * size
    xyxy = torch.cat([b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2], -1)
    out = {"boxes": torch.where(valid[..., None], xyxy, 0.0),
           "scores": torch.where(valid, top, 0.0),
           "classes": torch.where(valid, torch.gather(cls, 1, sel), -1),
           "valid": valid}
    pad = det["max_detections"] - m
    if pad > 0:
        out = {k: torch.cat([v, torch.full((n, pad, *v.shape[2:]), -1 if k == "classes" else 0,
                                           dtype=v.dtype, device=v.device)], 1)
               for k, v in out.items()}
    return out


def detect(model: PlainRTDETR, x: torch.Tensor, det: dict) -> dict[str, torch.Tensor]:
    """Model input -> detections in input pixels (``outputs``)."""
    boxes, logits = model.forward(x)
    return outputs(boxes, logits, x.shape[-1], det)
