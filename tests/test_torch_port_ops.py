"""The port's host and tensor ops against their JAX counterparts.

Same numpy-seeded inputs through both.  Floats in float32 are held at 1e-5
(absolute, on values of order 1-1000 px; the two frameworks round a few
elementwise steps differently), indices, ids and masks exactly, and the
numpy 2x I420 packer within 1 LSB of the reference package's packer.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.ops import iou as jiou
from rtmodt_tpu.ops import kalman as jkf
from rtmodt_tpu.ops import yuv as jyuv
from rtmodt_tpu.ops.assignment import greedy_assign as jax_greedy_assign
from rtmodt_tpu_torch.ops import iou as tiou
from rtmodt_tpu_torch.ops import kalman as tkf
from rtmodt_tpu_torch.ops import yuv as tyuv
from rtmodt_tpu_torch.ops.assignment import greedy_assign
from tests.conftest import random_boxes

GEOMETRIES = [(720, 1280, 640), (1080, 1920, 640), (480, 640, 320), (144, 256, 128),
              (361, 641, 256)]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("h,w,size", GEOMETRIES)
def test_content_dims_and_packed_meta(h, w, size):
    assert tyuv.content_dims(h, w, size) == jyuv.content_dims(h, w, size)
    assert tuple(tyuv.packed_meta(h, w, size)) == tuple(jyuv.packed_meta(h, w, size))


@pytest.mark.parametrize("h,w,size", GEOMETRIES[2:])
def test_planar_letterbox_matches_jax(h, w, size):
    rng = np.random.default_rng(h)
    ch, cw = tyuv.content_dims(h, w, size)
    m = tyuv.packed_meta(h, w, size)
    y = rng.integers(0, 256, (2, ch, cw), dtype=np.uint8)
    u = rng.integers(0, 256, (2, ch // 2, cw // 2), dtype=np.uint8)
    v = rng.integers(0, 256, (2, ch // 2, cw // 2), dtype=np.uint8)
    got = tyuv.planar_letterbox(_t(y), _t(u), _t(v), size, m.pad_left, m.pad_top,
                                dtype=torch.float32).numpy()
    assert got.shape == (2, size, size, 3)
    for i in range(2):
        want = np.asarray(jyuv.planar_letterbox(
            jnp.asarray(y[i]), jnp.asarray(u[i]), jnp.asarray(v[i]), size, m.pad_left,
            m.pad_top, dtype=jnp.float32))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,size", GEOMETRIES)
def test_unletterbox_boxes_packed_matches_jax(h, w, size):
    rng = np.random.default_rng(w)
    boxes = random_boxes(rng, 40, w=size, h=size, min_size=2, max_size=size // 3)
    boxes[:5] -= 30.0                       # off the content: exercises the clip
    m = tyuv.packed_meta(h, w, size)
    got = tyuv.unletterbox_boxes_packed(_t(boxes)[None], m)[0].numpy()
    want = np.asarray(jyuv.unletterbox_boxes_packed(jnp.asarray(boxes), m))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_pack_chunk_2x_within_one_lsb_of_reference():
    from rtmodt_tpu.utils.synthetic import moving_boxes_frame

    rng = np.random.default_rng(3)
    frames = np.stack([moving_boxes_frame(t, 720, 1280, 8)[0] for t in (0, 7)]
                      + [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)])
    (y, u, v), meta = tyuv.pack_chunk(frames, 640)
    (jy, ju, jv), jmeta = jyuv.pack_chunk(frames, 640)
    assert tuple(meta) == tuple(jmeta)
    for a, b in ((y, jy), (u, ju), (v, jv)):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_synthetic_frames_match_reference():
    from rtmodt_tpu.utils.synthetic import moving_boxes_frame as jframe
    from rtmodt_tpu_torch.utils.synthetic import moving_boxes_frame as tframe

    for t in (0, 5, 40):
        a, ab = tframe(t, 144, 256, 5, seed=2)
        b, bb = jframe(t, 144, 256, 5, seed=2)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ab, bb)


def test_iou_and_box_conversions_match_jax():
    rng = np.random.default_rng(0)
    a = random_boxes(rng, 30)
    b = random_boxes(rng, 20)
    b[:3] = a[:3]
    np.testing.assert_allclose(tiou.pairwise_iou(_t(a), _t(b)).numpy(),
                               np.asarray(jiou.pairwise_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-6)
    m = tiou.xyxy_to_cxcyah(_t(a)).numpy()
    np.testing.assert_allclose(m, np.asarray(jiou.xyxy_to_cxcyah(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tiou.cxcyah_to_xyxy(_t(m)).numpy(),
                               np.asarray(jiou.cxcyah_to_xyxy(jnp.asarray(m))),
                               rtol=1e-6, atol=1e-5)


def test_kalman_matches_jax():
    rng = np.random.default_rng(1)
    meas = np.asarray(jiou.xyxy_to_cxcyah(jnp.asarray(random_boxes(rng, 16))))
    ts = tkf.initiate(_t(meas))
    js = jkf.initiate(jnp.asarray(meas))
    for step in range(4):
        ts, js = tkf.predict(ts), jkf.predict(js)
        z = meas + rng.normal(0, 3, meas.shape).astype(np.float32)
        np.testing.assert_allclose(
            tkf.gating_distance(ts, _t(z)[None]).numpy(),
            np.asarray(jkf.gating_distance(js, jnp.asarray(z)[None])), rtol=1e-5, atol=1e-5)
        ts, js = tkf.update(ts, _t(z)), jkf.update(js, jnp.asarray(z))
        np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(ts.cov.numpy(), np.asarray(js.cov), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,r,c,thr", [(0, 12, 9, 0.3), (1, 256, 100, 0.2),
                                          (2, 7, 30, 0.5), (3, 40, 40, 0.0)])
def test_greedy_assign_matches_jax(seed, r, c, thr):
    rng = np.random.default_rng(seed)
    sim = rng.uniform(0, 1, (r, c)).astype(np.float32)
    sim = np.round(sim * 16) / 16                  # many exact ties
    sim[rng.uniform(size=(r, c)) < 0.05] = np.nan
    row_valid = rng.uniform(size=r) < 0.8
    col_valid = rng.uniform(size=c) < 0.8
    got = greedy_assign(_t(sim), thr, _t(row_valid), _t(col_valid))
    want = jax_greedy_assign(jnp.asarray(sim), thr, jnp.asarray(row_valid),
                             jnp.asarray(col_valid))
    np.testing.assert_array_equal(got.row_to_col.numpy(), np.asarray(want.row_to_col))
    np.testing.assert_array_equal(got.col_to_row.numpy(), np.asarray(want.col_to_row))
    assert got.rounds == int(want.rounds)


def test_config_defaults_match_reference_default_yaml():
    from rtmodt_tpu.config.loader import load_config as jax_load
    from rtmodt_tpu_torch.config import load_config

    def same_fields(port_section, ref_section):
        for f in dataclasses.fields(port_section):
            got, want = getattr(port_section, f.name), getattr(ref_section, f.name)
            if dataclasses.is_dataclass(got):
                same_fields(got, want)
            elif isinstance(got, list) and got and dataclasses.is_dataclass(got[0]):
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    same_fields(g, w)
            else:
                assert got == want, f.name

    port, ref = load_config(), jax_load()
    for name in ("detection", "tracking", "events", "parallel"):
        same_fields(getattr(port, name), getattr(ref, name))


def test_config_loads_reference_yaml_and_rejects_unported_settings():
    from rtmodt_tpu.config.loader import default_config_path
    from rtmodt_tpu_torch.config import load_config

    cfg = load_config(default_config_path(), overrides={"parallel": {"chunk_size": 16}})
    assert cfg.parallel.chunk_size == 16 and cfg.detection.model == "yolov8s"
    with pytest.raises(ValueError):
        load_config(overrides={"events": {"alert": {"backend": "mqtt"}}})
    with pytest.raises(ValueError):
        load_config(overrides={"detection": {"quant": "int8"}})
    with pytest.raises(KeyError):
        load_config(overrides={"detection": {"no_such_key": 1}})


@pytest.mark.parametrize("section,key,accepted,refused", [
    ("detection", "topk_impl", "approx", "fast"),
    ("detection", "quant", "none", "int8"),
])
def test_config_drops_reference_only_keys_and_refuses_unported_values(
        section, key, accepted, refused):
    from rtmodt_tpu_torch.config import load_config

    cfg = load_config(overrides={section: {key: accepted}})
    assert not hasattr(getattr(cfg, section), key)
    with pytest.raises(ValueError, match=key):
        load_config(overrides={section: {key: refused}})


@pytest.mark.parametrize("case", ["device_masks", "transports", "x24_ineligible"])
def test_config_takes_device_masks_and_the_transports(case):
    """``events.device_masks`` and every ``parallel.transport`` load as the
    reference loads them (with its refusals); x24 pinned on a geometry it
    cannot block raises when the pipeline meets that geometry."""
    from rtmodt_tpu.config.loader import load_config as jax_load
    from rtmodt_tpu_torch.config import load_config
    from rtmodt_tpu_torch.ops.yuv import s2d_level

    if case == "device_masks":
        cfg = load_config(overrides={"events": {"device_masks": True, "max_vertices": 8}})
        assert cfg.events.device_masks is True and cfg.events.max_vertices == 8
    elif case == "transports":
        for t in ("packed", "x6", "x24", "i420", "bgr"):
            assert load_config(overrides={"parallel": {"transport": t}}).parallel.transport == t
        for bad in ({"parallel": {"transport": "rgb"}},
                    {"parallel": {"transport": "x6"}, "tracking": {"algorithm": "deepsort"}},
                    {"parallel": {"transport": "x24"}, "tracking": {"algorithm": "botsort"}}):
            with pytest.raises(ValueError) as port_err:
                load_config(overrides=bad)
            with pytest.raises(ValueError) as ref_err:
                jax_load(overrides=bad)
            assert str(port_err.value) == str(ref_err.value)
    else:
        cfg = load_config(overrides={"parallel": {"transport": "x24"},
                                     "detection": {"input_size": 256}})
        assert s2d_level(cfg.parallel.transport, 288, 512, 256) == 2
        with pytest.raises(ValueError, match="x24 pinned"):
            s2d_level(cfg.parallel.transport, 300, 500, 256)
