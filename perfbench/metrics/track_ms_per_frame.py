"""The host's part of the chunk's tracker (``Pipeline.track_chunk``: on the
card one CUDA-graph replay of the T ByteTrack steps with its copies): the
program's ``track`` spans less their ``sync`` children (the host's reads of
a greedy round), milliseconds a frame over the chunks submitted."""


def read(run):
    return run.program_ms_per_frame("track")
