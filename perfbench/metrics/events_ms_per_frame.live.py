"""The open-loop cells' events_ms_per_frame: the same reading as
``perfbench/metrics/events_ms_per_frame.py``, moving the latency tail."""

from perfbench.metrics_common import load_reader

read = load_reader("events_ms_per_frame")
