"""The numpy model of the greedy-NMS kernel's wide path
(tests/test_torch_port_nms_wide.py) at K = 2048: two full compaction tiles,
64 conflict groups, 64 scan blocks.

The sequential oracle's Python loop costs ~5 us a pair of kept rows (10-18
s a scene here where most rows are kept), so it checks the random scene
and the scenes that keep few rows; every scene is held to the plain
version, which tests/test_torch_port_nms_wide_pack.py holds to the JAX
fixpoint at this K.
"""

from __future__ import annotations

import pytest

from tests.test_torch_port_nms_wide import check_wide_model
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

# (name, threshold, against the sequential oracle too)
CASES = ([(name, 0.45, True) for name in ("random", "identical", "one_valid", "no_valid")]
         + [(name, 0.45, False) for name in ("holes", "class_offset", "zero_score")]
         + [("holes", 0.9999, False), ("degenerate", 0.0, False)])


@pytest.mark.parametrize("name,t,oracle", CASES)
def test_wide_model_at_2048(name, t, oracle):
    check_wide_model(name, 2048, t, oracle)
