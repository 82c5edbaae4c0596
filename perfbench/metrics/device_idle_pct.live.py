"""The open-loop cells' device_idle_pct: the same reading as
``perfbench/metrics/device_idle_pct.py``, moving the latency tail."""

from perfbench.metrics_common import load_reader

read = load_reader("device_idle_pct")
