"""Camera-motion compensation, ROI crops and the appearance embedder of the
port against the JAX package on the CPU.

  * ``luma_grid`` of BGR frames and of half-resolution luma planes within
    1e-4 (values 0-255; the resize is two f32 matmuls whose summation order
    differs); ``half_res_luma`` exact;
  * ``phase_shift`` on the scenes of ``tests/test_gmc.py`` (integer and
    sub-pixel circular shifts, canvas pans, identical, flat, uncorrelated
    and out-of-range frames): the same correlation peak, the shift within
    0.1 grid units and the confidence within 25 % relative, and the same
    side of the ``min_ratio`` gate on every scene.  Two float32 FFTs agree
    no closer: the normalised cross-power spectrum divides by near-zero
    magnitudes at the window's stop band, so the reference's own float32
    result is as far from a float64 run (up to 0.06 grid units, and a
    confidence off by 2x on identical frames, where the second peak is
    noise).  The gated scenes sit at confidence >= 3.2 and the refused
    ones at <= 1.05 against ``min_ratio`` 1.5;
  * ``compensate`` exact on ByteTrack, OC-SORT and DeepSORT states, and
    ``gmc_step`` with its carry;
  * ``crop_and_resize`` and ``crop_yuv_rgb`` within 1e-3 on the 0-255 scale,
    on boxes inside, across and outside the image and degenerate ones;
  * the embedder: the carried weights equal, and features within 1e-5 in
    float32 with ``checkpoints/embedder.npz`` and with the reference's own
    random init carried over.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmodt_tpu.models.embedder import _flatten as jax_flatten
from rtmodt_tpu.models.embedder import init_embedder as jax_init_embedder
from rtmodt_tpu.ops import gmc as jgmc
from rtmodt_tpu.ops import roi as jroi
from rtmodt_tpu.tracking.bytetrack import init_track_state as jax_init_bt
from rtmodt_tpu.tracking.deepsort import init_deepsort_state as jax_init_ds
from rtmodt_tpu.tracking.ocsort import init_ocsort_state as jax_init_oc
from rtmodt_tpu_torch.config.loader import GMCConfig
from rtmodt_tpu_torch.models.embedder import AppearanceEmbedder, init_embedder
from rtmodt_tpu_torch.models.weights import embedder_params_from_jax
from rtmodt_tpu_torch.ops import gmc, roi
from rtmodt_tpu_torch.tracking.bytetrack import TrackState
from rtmodt_tpu_torch.tracking.deepsort import DeepSortState
from rtmodt_tpu_torch.tracking.ocsort import OCSortState
from tests.test_gmc import _circular_shift, _noise_field
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

EMBEDDER = "checkpoints/embedder.npz"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape", [(720, 1280, 3), (288, 512, 3), (100, 300, 3), (360, 640),
                                   (144, 256), (128, 128), (128, 300)])
def test_luma_grid_matches(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(jgmc.luma_grid(jnp.asarray(img), 128))
    got = gmc.luma_grid(_t(img), 128).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if len(shape) == 2 and shape[0] % 2 == 0:
        np.testing.assert_array_equal(gmc.half_res_luma(_t(img)).numpy(),
                                      np.asarray(jgmc.half_res_luma(jnp.asarray(img))))
        want = np.asarray(jgmc.luma_grid(jgmc.half_res_luma(jnp.asarray(img)), 64))
        np.testing.assert_allclose(gmc.luma_grids(gmc.half_res_luma(_t(img[None])), 64)[0],
                                   want, rtol=0, atol=1e-4)


def _scenes():
    g = 128
    prev = _noise_field(g)
    out = [(f"circ{dx},{dy}", prev, _circular_shift(prev, dx, dy))
           for dx, dy in [(5, 0), (0, -7), (12, 9), (-15, -3)]]
    p3 = _noise_field(g, seed=3)
    out += [(f"sub{dx},{dy}", p3, _circular_shift(p3, dx, dy))
            for dx, dy in [(2.5, 0.0), (-3.25, 1.75), (0.4, -0.4)]]
    big = _noise_field(2 * g, seed=7)
    o = 32
    out += [(f"pan{cx},{cy}", big[o:o + g, o:o + g], big[o + cy:o + cy + g, o + cx:o + cx + g])
            for cx, cy in [(8, 0), (-10, 5), (15, 15)]]
    img = _noise_field(64, seed=1)
    out += [("identical", img, img), ("flat", np.full((64, 64), 37.0), np.full((64, 64), 37.0)),
            ("uncorrelated", _noise_field(64, seed=11), _noise_field(64, seed=12)),
            ("excessive", prev, _circular_shift(prev, 50, 0))]
    return out


@pytest.mark.parametrize("name,prev,cur", _scenes(), ids=[s[0] for s in _scenes()])
def test_phase_shift_matches(name, prev, cur):
    prev, cur = prev.astype(np.float32), cur.astype(np.float32)
    ws, wc = jgmc.phase_shift(jnp.asarray(prev), jnp.asarray(cur))
    gs, gc = gmc.phase_shift(_t(prev), _t(cur))
    ws, wc = np.asarray(ws), float(wc)
    np.testing.assert_array_equal(np.round(gs.numpy()), np.round(ws))      # the same peak
    np.testing.assert_allclose(gs.numpy(), ws, rtol=0, atol=0.1)
    assert float(gc) == pytest.approx(wc, rel=0.25, abs=1e-6)
    # the gate: the same decision on both sides, far from the threshold
    assert (float(gc) >= 1.5) == (wc >= 1.5)
    assert wc >= 3.2 or wc <= 1.05
    if wc < 1.5:                                  # refused: exactly no shift
        assert not (gs != 0).any() and not (ws != 0).any()


def _random_fields(cls, rng, s=12, ring=4, embed=8):
    shapes = {"boxes": (s, 4), "kf_mean": (s, 8), "kf_cov": (s, 4, 3), "last_obs": (s, 4),
              "obs_ring": (s, ring, 4), "velocity": (s, 2), "feat": (s, embed),
              "confidence": (s,)}
    out = {}
    for name in cls._fields:
        if name in shapes:
            out[name] = rng.uniform(-50, 500, shapes[name]).astype(np.float32)
        elif name == "active":
            out[name] = rng.uniform(size=s) < 0.5
        elif name in ("next_id", "frame_count"):
            out[name] = np.int32(7)
        else:
            out[name] = rng.integers(0, 9, s).astype(np.int32)
    return out


@pytest.mark.parametrize("init,cls", [(jax_init_bt, TrackState), (jax_init_oc, OCSortState),
                                      (jax_init_ds, DeepSortState)])
def test_compensate_is_exact(init, cls):
    rng = np.random.default_rng(5)
    fields = _random_fields(cls, rng)
    jstate = type(init(4))(**{k: jnp.asarray(v) for k, v in fields.items()})
    shift = np.asarray([3.25, -7.5], np.float32)
    want = jgmc.compensate(jstate, jnp.asarray(shift))
    got = gmc.compensate(cls(**{k: _t(v) for k, v in fields.items()}), _t(shift))
    for name in cls._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_gmc_step_carries_the_grid():
    from rtmodt_tpu.config.loader import GMCConfig as JaxGMCConfig

    rng = np.random.default_rng(2)
    big = _noise_field(256, seed=9)
    frames = [np.clip(big[o:o + 96, p:p + 160], 0, 255).astype(np.uint8)
              for o, p in [(40, 40), (44, 31), (30, 52)]]
    fields = _random_fields(TrackState, rng)
    jst = type(jax_init_bt(4))(**{k: jnp.asarray(v) for k, v in fields.items()})
    tst = TrackState(**{k: _t(v) for k, v in fields.items()})
    jc = (jnp.zeros((64, 64), jnp.float32), jnp.float32(0.0))
    tc = gmc.init_carry(64, "cpu")
    jcfg, tcfg = JaxGMCConfig(method="phase", grid=64), GMCConfig(method="phase", grid=64)
    for f in frames:
        jst, jc = jgmc.gmc_step(jst, jnp.asarray(f), jc, jcfg, (160 / 64, 96 / 64))
        tst, tc = gmc.gmc_step(tst, _t(f), tc, tcfg, (160 / 64, 96 / 64))
        np.testing.assert_allclose(tst.boxes.numpy(), np.asarray(jst.boxes), rtol=0, atol=1e-3)
        np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), rtol=0, atol=1e-4)
        assert float(tc[1]) == float(jc[1]) == 1.0
    assert np.abs(tst.boxes.numpy() - fields["boxes"]).max() > 5      # it did shift


def _roi_boxes(rng, h, w, d=24):
    xy = rng.uniform(-30, max(h, w), (d, 2))
    wh = rng.uniform(0, 120, (d, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[0] = [5, 5, 5, 5]               # degenerate
    boxes[1] = [w + 10, h + 10, w + 50, h + 80]   # outside
    boxes[2] = [-20, -20, w + 20, h + 20]          # across
    return boxes


def test_crop_and_resize_matches():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (120, 200, 3)).astype(np.uint8)
    boxes = _roi_boxes(rng, 120, 200)
    want = np.asarray(jroi.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), (64, 32)))
    got = roi.crop_and_resize(_t(img), _t(boxes), (64, 32)).numpy()
    assert got.shape == (24, 64, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_crop_yuv_rgb_matches():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (128, 192)).astype(np.uint8)
    u = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    v = rng.integers(0, 256, (64, 96)).astype(np.uint8)
    boxes = _roi_boxes(rng, 128, 192)
    want = np.asarray(jroi.crop_yuv_rgb(*(jnp.asarray(p, jnp.float32) for p in (y, u, v)),
                                        jnp.asarray(boxes), (64, 32)))
    got = roi.crop_yuv_rgb(*(_t(p).float() for p in (y, u, v)), _t(boxes), (64, 32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert got.min() >= 0 and got.max() <= 255


def _jax_flat(params) -> dict:
    return {k: np.asarray(v) for k, v in jax_flatten(jax.device_get(params)).items()}


@pytest.mark.parametrize("weights", ["shipped", "reference_random"])
def test_embedder_matches(weights, tmp_path):
    rng = np.random.default_rng(3)
    model, params = jax_init_embedder((64, 32), 128, EMBEDDER if weights == "shipped" else "")
    flat = _jax_flat(params)
    assert len(flat) == 14
    path = EMBEDDER
    if weights == "reference_random":
        path = str(tmp_path / "ref_init.npz")
        np.savez(path, **flat)
    port = init_embedder((64, 32), 128, path)
    sd = embedder_params_from_jax(flat)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
    np.testing.assert_array_equal(port.down1.weight.detach().numpy(),
                                  flat["params/down1/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port.proj.weight.detach().numpy(), flat["params/proj/kernel"].T)
    for hw in [(64, 32), (33, 17)]:
        x = rng.uniform(0, 255, (6, *hw, 3)).astype(np.float32)
        want = np.asarray(model.apply(params, jnp.asarray(x)))
        with torch.no_grad():
            got = port(_t(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_embedder_weights_chain(tmp_path):
    bad = tmp_path / "bad.npz"
    np.savez(bad, **{"params/down1/kernel": np.zeros((3, 3, 3, 32), np.float32)})
    with pytest.raises(ValueError, match="missing keys"):
        init_embedder((64, 32), 128, str(bad))
    with pytest.raises(ValueError, match="shape mismatch"):
        init_embedder((64, 32), 64, EMBEDDER)
    a, b = init_embedder((64, 32), 128, ""), init_embedder((64, 32), 128, "")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k                                 # seeded
    assert isinstance(a, AppearanceEmbedder) and not a.training
