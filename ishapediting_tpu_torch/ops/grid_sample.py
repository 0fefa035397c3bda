"""Bilinear grid sampling with ``F.grid_sample`` semantics over NHWC maps
(mode='bilinear', padding_mode='zeros'), written as gathers and lerps so the
layout matches the JAX package's (reference: axisnetworks.py:537-544).

``grid[..., 0]`` = x indexes the width axis, ``grid[..., 1]`` = y the height
axis, both in [-1, 1]; with ``align_corners=True`` -1 maps to pixel 0 and +1
to pixel size-1.
"""

from __future__ import annotations

import torch


def grid_sample_2d(
    feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = True
) -> torch.Tensor:
    """Sample ``feat`` [N, H, W, C] at ``grid`` [N, ..., 2] -> [N, ..., C].
    Out-of-range corners contribute zero, like torch's zero padding."""
    if feat.ndim != 4:
        raise ValueError(f"feat must be [N,H,W,C], got {tuple(feat.shape)}")
    n, h, w, c = feat.shape
    batch_shape = grid.shape[:-1]
    grid = grid.reshape(n, -1, 2).float()
    x, y = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (x + 1.0) * 0.5 * (w - 1)
        iy = (y + 1.0) * 0.5 * (h - 1)
    else:
        ix = ((x + 1.0) * w - 1.0) * 0.5
        iy = ((y + 1.0) * h - 1.0) * 0.5

    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    ix1, iy1 = ix0 + 1.0, iy0 + 1.0
    wx1, wy1 = ix - ix0, iy - iy0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = feat.reshape(n, h * w, c)

    def gather(iy_f, ix_f):
        valid = (ix_f >= 0) & (ix_f <= w - 1) & (iy_f >= 0) & (iy_f <= h - 1)
        xi = ix_f.clamp(0, w - 1).long()
        yi = iy_f.clamp(0, h - 1).long()
        idx = (yi * w + xi)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx) * valid[..., None].to(feat.dtype)

    out = (
        gather(iy0, ix0) * (wy0 * wx0)[..., None].to(feat.dtype)
        + gather(iy0, ix1) * (wy0 * wx1)[..., None].to(feat.dtype)
        + gather(iy1, ix0) * (wy1 * wx0)[..., None].to(feat.dtype)
        + gather(iy1, ix1) * (wy1 * wx1)[..., None].to(feat.dtype)
    )
    return out.reshape(*batch_shape, c)
