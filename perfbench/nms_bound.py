"""The least time K1 (greedy NMS suppression, ``csrc/nms_kernel.cu``) could
take on these inputs, for a later ``nms_roofline`` metric (copied from the
smoke's ``nms_bound_ms``).

bytes = every score read once (4 B) + every keep flag written once (1 B) +
the box (16 B) of each valid candidate only, since a row with score <= 0
never suppresses and is never kept, and for K > 1024 (the wide path, whose
conflict words cannot stay on chip) the words on or right of each row's
diagonal group written once and read once (4 B each); operations = the IoU
test of every pair of valid candidates (i < j, 14 float32 operations) plus 3
a valid candidate's area."""

from __future__ import annotations

import numpy as np

from perfbench.peaks import F32_FLOPS, HBM_BYTES

ONE_CTA_MAX_K = 1024


def nms_bound_ms(valid_counts: list[int], k: int) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") of one launch over
    frames with ``valid_counts`` valid candidates each among ``k``."""
    b = len(valid_counts)
    v = np.asarray(valid_counts, np.float64)
    nbytes = b * k * 4 + b * k + float(v.sum()) * 16
    if k > ONE_CTA_MAX_K:
        for n in v.astype(np.int64).tolist():
            rows = np.arange(n)
            nbytes += 2 * 4 * float(((n + 31) // 32 - rows // 32).sum())
    ops = float((v * (v - 1) / 2 * 14 + 3 * v).sum())
    t_bytes, t_ops = nbytes / HBM_BYTES, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
