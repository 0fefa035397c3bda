"""Feature-space plumbing for drag editing (reference: drag_utils.py:134-159,
316-334).

- ``regroup_features`` splits a tapped UNet activation into per-triplane
  feature planes.
- ``plane_grids`` projects 3D handle-point neighborhoods onto the three plane
  coordinate systems for ``grid_sample`` lookups.
- ``complement_masks`` marks the plane pixels outside every neighborhood's
  integer projection (the reference's Python-set difference as a mask).

Internal feature layout is planes-first NHWC: ``[3, s, s, C']`` per step;
channel grouping matches the reference exactly. The handle geometry is
host-side NumPy, built once per drag request.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ishapediting_tpu_torch.ops.nn import channel_nearest_resize


def regroup_features(feat: torch.Tensor, cat_var: bool = True) -> torch.Tensor:
    """[B, s, s, 2C] tapped activation -> [B, 3, s, s, C''] fp32 plane features.

    Channels split into mean/var halves, each truncated to a multiple of 3
    with nearest-neighbor channel resampling, grouped contiguously into the
    three planes, then (optionally) re-concatenated.
    """
    b, s1, s2, c2 = feat.shape
    assert c2 % 2 == 0, c2
    c = c2 // 2
    mean, var = feat[..., :c], feat[..., c:]
    if c % 3:
        c -= c % 3
        mean = channel_nearest_resize(mean, c)
        var = channel_nearest_resize(var, c)

    def to_planes(x):
        return x.reshape(b, s1, s2, 3, c // 3).permute(0, 3, 1, 2, 4)

    if not cat_var:
        return to_planes(mean).float()
    return torch.cat([to_planes(mean), to_planes(var)], dim=-1).float()


def make_offsets(r: int) -> np.ndarray:
    """Cubic neighborhood offsets [-r..r]^3 -> [(2r+1)^3, 3]
    (reference: drag_utils.py:134-138)."""
    p = np.arange(-r, r + 1)
    px, py, pz = np.meshgrid(p, p, p, indexing="ij")
    return np.stack([px.reshape(-1), py.reshape(-1), pz.reshape(-1)], axis=-1)


def neighborhood_points(points: np.ndarray, r: int, voxel_size: float) -> np.ndarray:
    """[B, 3] handle points -> [B, N1, 3] cubic neighborhoods
    (reference: drag_utils.py:316-317)."""
    offsets = make_offsets(r).astype(np.float32)
    return points[:, None, :] + voxel_size * offsets[None, :, :]


def plane_grids(pnt: np.ndarray) -> np.ndarray:
    """[B, N1, 3] points -> [3, B, N1, 2] grid_sample coordinates for the
    xy / yz / xz planes (reference: drag_utils.py:318-321)."""
    return np.stack([pnt[..., 0:2], pnt[..., 1:3], pnt[..., ::2]], axis=0)


def complement_masks(
    patch_pnt: np.ndarray, shift_pnt: np.ndarray, width: int
) -> Tuple[np.ndarray, float]:
    """Per-plane masks [3, width, width] (float32, 1 where a pixel is outside
    both neighborhoods' integer projections, reference: drag_utils.py:322-334)
    and the total complement pixel count. Index convention per plane
    (row, col): xy (y, x), yz (z, y), xz (z, x)."""
    pts = np.concatenate([patch_pnt.reshape(-1, 3), shift_pnt.reshape(-1, 3)], axis=0)
    ints = np.round((pts + 1.0) * (width - 1) / 2.0).astype(np.int64)
    ints = np.clip(ints, 0, width - 1)
    mask = np.ones((3, width, width), dtype=np.float32)
    x, y, z = ints[:, 0], ints[:, 1], ints[:, 2]
    mask[0, y, x] = 0.0
    mask[1, z, y] = 0.0
    mask[2, z, x] = 0.0
    return mask, float(mask.sum())
