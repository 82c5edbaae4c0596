"""The least time G2 (deformable attention's sampling,
``csrc/msdeform_kernel.cu``) could take on one launch, for the
``msdeform_roofline`` metric.

bytes = the value maps read once (B x V x H x D elements) + the sampling
locations (B x Q x H x L x P x 2 float32) and attention weights (B x Q x H
x L x P float32) read once + the output written once (B x Q x H x D
elements); operations = 10 a point and channel (B x Q x H x L x P x D): the
four corners' products and sums (8) and the weighted sum (2).  The larger
of bytes over ``HBM_BYTES`` and operations over ``F32_FLOPS`` (the kernel
computes in float32 outside the tensor cores), as ``nms_bound.py`` does."""

from __future__ import annotations

from perfbench.peaks import F32_FLOPS, HBM_BYTES

OPS_PER_POINT_CHANNEL = 10


def msdeform_work(batch: int, len_v: int, len_q: int, heads: int, levels: int, points: int,
                  head_dim: int, elem_bytes: int = 2) -> tuple[float, float]:
    """(bytes, operations) of one launch."""
    pts = batch * len_q * heads * levels * points
    nbytes = (batch * len_v * heads * head_dim * elem_bytes + pts * 3 * 4
              + batch * len_q * heads * head_dim * elem_bytes)
    return float(nbytes), float(OPS_PER_POINT_CHANNEL * pts * head_dim)


def msdeform_bound_s(batch: int, len_v: int, len_q: int, heads: int, levels: int, points: int,
                     head_dim: int, elem_bytes: int = 2) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") of one launch."""
    nbytes, ops = msdeform_work(batch, len_v, len_q, heads, levels, points, head_dim, elem_bytes)
    t_bytes, t_ops = nbytes / HBM_BYTES, ops / F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cell_bound_s(conf: dict, frames: int) -> tuple[float, str]:
    """``msdeform_bound_s`` of one launch over ``frames`` frames of an RT-DETR
    configuration file (bf16 value maps under ``detection.half``)."""
    s = conf["pipeline"]["detection"]["input_size"]
    len_v = sum((s // st) ** 2 for st in (8, 16, 32))
    elem = 2 if conf["pipeline"]["detection"].get("half", True) else 4
    return msdeform_bound_s(frames, len_v, conf["num_queries"], conf["num_heads"],
                            conf["num_levels"], conf["num_points"],
                            conf["hidden_dim"] // conf["num_heads"], elem)
