"""The whole step's share of the card's bf16 peak: the forward's operations a
frame (``perfbench/flops.py``, from the configuration's conv shapes) times
the frames completed a second, over 989 TFLOP/s (H100 SXM, dense bf16), in
percent.  Frames and time are the window's outside the profiled
sub-window."""

from perfbench.peaks import BF16_FLOPS


def read(run):
    if run.window_s <= 0 or run.frames_done == 0:
        return None
    return 100.0 * run.flops_per_frame * run.frames_per_s() / BF16_FLOPS
