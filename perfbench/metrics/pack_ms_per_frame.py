"""Host pack (``ops/yuv.py::pack_chunk``, the native ``csrc/framepack.cpp``):
the harness's ``pack`` span, milliseconds a frame."""


def read(run):
    return run.ms_per_frame("pack")
