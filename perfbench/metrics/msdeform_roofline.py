"""G2's share of its roofline: the least time of the deformable sampling
kernel's launches in the traced sub-window (``perfbench/msdeform_bound.py``,
one launch a decoder layer over a chunk's frames) over their time in the
trace's ``kernel_table`` (``msdeform_kernel``), in percent; None where the
trace holds no such kernel."""

from perfbench.msdeform_bound import cell_bound_s

KERNEL = "msdeform_kernel"


def read(run):
    if run.trace is None or run.config is None:
        return None
    row = run.trace.get("kernel_table", {}).get(KERNEL)
    if not row or row["seconds"] <= 0:
        return None
    bound, _ = cell_bound_s(run.config, run.frames_per_chunk)
    return 100.0 * bound * row["launches"] / row["seconds"]
