"""The open-loop cells' pack_ms_per_frame: the same reading as
``perfbench/metrics/pack_ms_per_frame.py``, moving the latency tail."""

from perfbench.metrics_common import load_reader

read = load_reader("pack_ms_per_frame")
