"""Global (camera) motion estimation: FFT phase correlation (port of
``rtmodt_tpu/ops/gmc.py``).

A pan or tilt makes every track's Kalman prediction miss sideways at once.
The dominant TRANSLATION between consecutive frames is estimated by phase
correlation of downsampled luma grids (two small FFTs and an argmax on the
device), and the track state is shifted into current-frame coordinates
before association (``compensate``).

Sign convention: ``phase_shift`` returns the CONTENT displacement d with
cur(x) ~= prev(x - d); state stored in previous-frame coordinates is brought
into current-frame coordinates by adding d.

``luma_grid`` resizes as ``jax.image.resize(..., "linear")`` does: a
triangle kernel widened by the downsampling factor (antialiased), weights
normalised per output sample, applied as two small matmuls.  That is
neither ``F.interpolate(mode="bilinear")`` nor its ``antialias=True``.
"""

from __future__ import annotations

import math

import torch


def half_res_luma(y: torch.Tensor) -> torch.Tensor:
    """2x2 box-average a (..., H, W) luma plane to half resolution (f32)."""
    *lead, h, w = y.shape
    return y.float().reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) f32 weights of ``jax.image.scale_and_translate`` with the
    linear (triangle) kernel, antialiased, translation 0."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs() \
        / kernel_scale
    wts = (1.0 - x.abs()).clamp(min=0.0)
    total = wts.sum(dim=0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                      wts / torch.where(total != 0, total, torch.ones_like(total)),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def _resize(img: torch.Tensor, grid: int) -> torch.Tensor:
    """Linear antialiased resize of the last two axes to (grid, grid); an
    axis already of size ``grid`` is left as it is (jax skips it too)."""
    h, w = img.shape[-2:]
    if h != grid:
        img = _resize_weights(h, grid, img.device).T @ img
    if w != grid:
        img = img @ _resize_weights(w, grid, img.device)
    return img


def luma_grid(img: torch.Tensor, grid: int = 128) -> torch.Tensor:
    """Downsample a frame to a (grid, grid) f32 luma raster.  ``img``: an
    (H, W) luma plane or an (H, W, 3) BGR/RGB frame (channel mean)."""
    img = img.float()
    if img.ndim == 3:
        img = img.mean(dim=-1)
    return _resize(img, grid)


def luma_grids(lumas: torch.Tensor, grid: int = 128) -> torch.Tensor:
    """``luma_grid`` of each of (K, h, w) luma planes -> (K, grid, grid)."""
    return _resize(lumas.float(), grid)


def _hann2d(n: int, device) -> torch.Tensor:
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi
                              * torch.arange(n, dtype=torch.float32, device=device) / n)
    return w[:, None] * w[None, :]


def phase_shift(prev: torch.Tensor, cur: torch.Tensor, min_ratio: float = 1.5,
                max_shift_frac: float = 0.25) -> tuple[torch.Tensor, torch.Tensor]:
    """Translation between two (G, G) luma grids by phase correlation (or
    between S streams' (S, G, G) grids, each pair on its own).

    Returns ``(shift_xy (..., 2) f32, conf (...) f32)``: the content
    displacement in grid units (dx, dy), and the ratio of the correlation
    peak to the highest peak outside its 15x15 circular neighbourhood.  The
    shift is zeroed when ``conf < min_ratio``, the peak is not positive, or
    ``|shift|`` exceeds ``G * max_shift_frac``.  Hann window, normalised
    cross-power spectrum, 3-point parabolic sub-pixel fit.  No host sync."""
    g = prev.shape[-1]
    lead = prev.shape[:-2]
    dev = prev.device
    w = _hann2d(g, dev)
    a = (prev - prev.mean(dim=(-2, -1), keepdim=True)) * w
    b = (cur - cur.mean(dim=(-2, -1), keepdim=True)) * w
    fa = torch.fft.rfft2(a)
    fb = torch.fft.rfft2(b)
    r = fb * torch.conj(fa)
    r = r / (r.abs() + 1e-9)
    corr = torch.fft.irfft2(r, s=(g, g))

    # every index stays on the device: a 0-d tensor used as an index would
    # read it back to the host
    flat_corr = corr.reshape(*lead, g * g)
    flat = torch.argmax(flat_corr, dim=-1)
    py, px = flat // g, flat % g
    taps = flat_corr.gather(-1, torch.stack([
        flat, ((py - 1) % g) * g + px, ((py + 1) % g) * g + px,
        py * g + (px - 1) % g, py * g + (px + 1) % g], dim=-1))
    peak, up, down, left, right = taps.unbind(-1)

    excl = 7
    ar = torch.arange(g, device=dev)
    iy = (ar[:, None] - py[..., None, None] + g // 2) % g - g // 2
    ix = (ar[None, :] - px[..., None, None] + g // 2) % g - g // 2
    near = (iy.abs() <= excl) & (ix.abs() <= excl)
    second = corr.masked_fill(near, -math.inf).amax(dim=(-2, -1))
    conf = peak / second.clamp(min=1e-9)

    def _axis(p, left, right):
        denom = left - 2.0 * peak + right
        frac = torch.where(denom.abs() > 1e-9, 0.5 * (left - right) / denom,
                           torch.zeros_like(denom))
        frac = frac.clamp(-0.5, 0.5)
        signed = ((p + g // 2) % g) - g // 2
        return signed.float() + frac

    dy = _axis(py, up, down)
    dx = _axis(px, left, right)

    limit = g * max_shift_frac
    ok = (conf >= min_ratio) & (peak > 1e-6) & (dx.abs() <= limit) & (dy.abs() <= limit)
    shift = torch.stack([dx, dy], dim=-1)
    return torch.where(ok[..., None], shift, torch.zeros_like(shift)), conf


def gmc_step(state, luma_src: torch.Tensor, carry, cfg, scale_xy):
    """One camera-motion-compensation step: grid this frame's luma (a luma
    plane, a BGR frame, or an already-made grid), phase-correlate it with the
    carried previous grid, shift the tracker state.  ``carry`` is
    ``(prev_grid (G, G) f32, valid () f32)``; ``valid = 0`` silences the
    first frame after init or reset.  ``scale_xy`` converts grid units to
    source pixels.  Returns ``(state', (cur_grid, 1.0))``.

    Streams: with an S-leading state and carry (``(S, G, G)``, ``(S,)``),
    ``luma_src`` holds S planes, frames or grids, and every stream is
    compensated by its own shift."""
    prev, valid = carry
    src = luma_src.float()
    if src.ndim == prev.ndim + 1:     # BGR/RGB frames: the channel mean
        src = src.mean(dim=-1)
    cur = _resize(src, cfg.grid)
    shift, _ = phase_shift(prev, cur, cfg.min_ratio, cfg.max_shift_frac)
    sv = shift * valid[..., None]
    state = compensate(state, torch.stack([sv[..., 0] * scale_xy[0], sv[..., 1] * scale_xy[1]],
                                          dim=-1))
    return state, (cur, torch.ones_like(valid))


def init_carry(grid: int, device, num_streams: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The carry before the first frame: a zero grid, valid = 0 (per stream
    with ``num_streams``)."""
    lead = () if num_streams is None else (num_streams,)
    return (torch.zeros((*lead, grid, grid), dtype=torch.float32, device=device),
            torch.zeros(lead, dtype=torch.float32, device=device))


# Tracker-state fields holding xyxy boxes: shifted by (dx, dy, dx, dy).
# kf_mean holds (cx, cy, a, h, velocities): only the centre shifts; the
# covariance is invariant under a pure translation.
_BOX_FIELDS = frozenset({"boxes", "last_obs", "obs_ring"})


def compensate(state, shift_xy: torch.Tensor):
    """Bring a fixed-slot tracker state (TrackState, DeepSortState or
    OCSortState) from previous-frame into current-frame coordinates;
    ``shift_xy`` is the (2,) content displacement in source pixels (or (S,
    2), one per stream of an S-leading state).  Inactive slots shift too
    (harmless)."""
    shift_xy = shift_xy.float()
    lead = shift_xy.shape[:-1]
    d4 = torch.cat([shift_xy, shift_xy], dim=-1)

    def per_slot(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(..., k) per stream -> broadcastable over ``x``'s slot axes."""
        return v.view(*lead, *([1] * (x.ndim - len(lead) - 1)), v.shape[-1])

    upd = {}
    for name in state._fields:
        if name in _BOX_FIELDS:
            x = getattr(state, name)
            upd[name] = x + per_slot(d4, x)
        elif name == "kf_mean":
            km = getattr(state, name)
            upd[name] = torch.cat([km[..., 0:2] + per_slot(shift_xy, km), km[..., 2:]], dim=-1)
    return state._replace(**upd)
