"""The frozen scene generators: the same seed gives the same frames."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import scenes


@pytest.mark.parametrize("scene,objects", [("moving_boxes", 8), ("dense", 64)])
def test_pool_is_deterministic_by_seed(scene, objects):
    a = scenes.make_pool(scene, 2, 3, 144, 256, objects, seed=3000000001)
    b = scenes.make_pool(scene, 2, 3, 144, 256, objects, seed=3000000001)
    c = scenes.make_pool(scene, 2, 3, 144, 256, objects, seed=3000000002)
    assert a.shape == (6, 2, 144, 256, 3) and a.dtype == np.uint8
    assert np.array_equal(a[3:], a[2::-1])          # the backward half
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[:, 0], a[:, 1])     # streams differ
    assert not np.array_equal(a[0], a[1])           # objects move


def test_moving_boxes_matches_the_program_s_generator():
    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame

    for t in (0, 7, 31):
        want, _ = moving_boxes_frame(t, 144, 256, 8, 12345)
        assert np.array_equal(scenes.moving_boxes_frame(t, 144, 256, 8, 12345), want)


def test_pool_index_replays_forward_then_backward():
    assert [scenes.pool_index(i, 3) for i in range(8)] == [0, 1, 2, 2, 1, 0, 0, 1]


def test_large_seeds():
    assert scenes.stream_seed(2**33 + 5, 1) != scenes.stream_seed(2**33 + 5, 2)
