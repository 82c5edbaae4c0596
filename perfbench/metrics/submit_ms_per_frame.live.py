"""The open-loop cells' submit_ms_per_frame: the same reading as
``perfbench/metrics/submit_ms_per_frame.py``, moving the latency tail."""

from perfbench.metrics_common import load_reader

read = load_reader("submit_ms_per_frame")
