"""The chunk program's detection (``runtime/pipeline.py::Pipeline.packed_detect``:
plane copies, planar letterbox, forward, K1 and unletterbox queued from the
host, and the host's waits for the card at its blocking copies): the
program's ``detect`` spans, milliseconds a frame over the chunks submitted."""


def read(run):
    return run.program_ms_per_frame("detect")
