"""The host's time queueing the model's forward (``models/rtdetr.py``): the
program's ``backbone``, ``encoder`` and ``decoder`` spans (the last with the
output step), milliseconds a frame over the chunks submitted, each span to
the chunk whose harness ``submit`` span holds it.  It grows if anything in
the forward reads the card.  None where the program recorded no such span."""

from perfbench.program_spans import by_chunk

NAMES = ("backbone", "encoder", "decoder")


def read(run):
    if not run.program_spans or not any(p.name in NAMES for p in run.program_spans):
        return None
    sub, _, n_sub, _ = by_chunk(run.spans, run.program_spans)
    if not n_sub:
        return None
    s = sum(p.t1 - p.t0 for items in sub.values() for p in items if p.name in NAMES)
    return 1e3 * s / (n_sub * run.frames_per_chunk)
