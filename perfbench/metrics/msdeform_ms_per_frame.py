"""G2, the deformable sampling kernel (``csrc/msdeform_kernel.cu``): its
device time in the traced sub-window's ``kernel_table`` over the traced
frames, milliseconds a frame (six launches a chunk, one a decoder layer);
None where the trace holds no such kernel."""

KERNEL = "msdeform_kernel"


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    row = run.trace.get("kernel_table", {}).get(KERNEL)
    if not row:
        return None
    return 1e3 * row["seconds"] / run.traced_frames
