"""Point-in-polygon tests on the device (``events.device_masks``).

The port's copy of ``rtmodt_tpu/ops/polygon.py``: every point against every
zone at once with the even-odd (ray casting) rule over padded fixed-shape
polygon vertex arrays, in plain torch on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_polygons(polygons: list[list[list[float]]], max_vertices: int) -> np.ndarray:
    """Pad a ragged list of polygons to a static (Z, V, 2) float32 array.

    Padding repeats each polygon's last vertex: the zero-length edges it adds
    cross no ray, so the padded polygons are the originals."""
    out = np.zeros((len(polygons), max_vertices, 2), dtype=np.float32)
    for i, poly in enumerate(polygons):
        pts = np.asarray(poly, dtype=np.float32)
        if len(pts) > max_vertices:
            raise ValueError(f"polygon {i} has {len(pts)} vertices > max_vertices={max_vertices}")
        out[i, :len(pts)] = pts
        out[i, len(pts):] = pts[-1]
    return out


def points_in_polygons(points: torch.Tensor, polygons: torch.Tensor,
                       eps: float = 1e-9) -> torch.Tensor:
    """Even-odd containment of points (N, 2) in polygons (Z, V, 2) -> (N, Z)
    bool.  Edges run v_k -> v_{(k+1) % V}; the padding's repeated vertices
    give edges with yi == yj, which the crossing condition rejects."""
    px = points[:, 0][:, None, None]                 # (N, 1, 1)
    py = points[:, 1][:, None, None]
    vx = polygons[None, :, :, 0]                     # (1, Z, V)
    vy = polygons[None, :, :, 1]
    nx = torch.roll(polygons[..., 0], -1, dims=-1)[None]
    ny = torch.roll(polygons[..., 1], -1, dims=-1)[None]
    straddles = (vy > py) != (ny > py)               # the edge spans the ray's y
    dy = ny - vy
    t = (py - vy) / torch.where(dy.abs() < eps, torch.full_like(dy, eps), dy)
    x_cross = vx + t * (nx - vx)
    crossings = (straddles & (px < x_cross)).sum(dim=-1)    # (N, Z)
    return (crossings % 2) == 1
