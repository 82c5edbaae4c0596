"""The chunk program (``MultiStreamPipeline.submit_chunk_packed``: planar
letterbox, forward, K1, batched ByteTrack with its host-synced rounds): the
harness's ``submit`` span, milliseconds a frame."""


def read(run):
    return run.ms_per_frame("submit")
