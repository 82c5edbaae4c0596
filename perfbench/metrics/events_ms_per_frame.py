"""Copy-out of the track outputs and the zone events
(``events/zone_engine.py``): the harness's ``copy``, ``wait`` and ``events``
spans, milliseconds a frame."""


def read(run):
    return run.ms_per_frame("copy", "wait", "events")
