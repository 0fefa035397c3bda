"""The drag losses of iShapEditing (``drag_utils.py``: the tapped feature
split into three planes, cubic handle neighbourhoods projected on the
planes, a motion term sampled with ``F.grid_sample`` and a mask term outside
the neighbourhoods), in plain fp32 PyTorch and NumPy. Imports nothing of the
program.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def plane_features(feat: torch.Tensor) -> torch.Tensor:
    """[N, 2C, s, s] tapped activation -> [N, 3, C'', s, s]: the mean and
    variance halves, each resized to a multiple of 3 channels (nearest) and
    cut into three planes, concatenated per plane."""
    n, c2, s1, s2 = feat.shape
    c = c2 // 2
    halves = [feat[:, :c], feat[:, c:]]
    if c % 3:
        k = c - c % 3
        halves = [F.interpolate(h.permute(0, 2, 3, 1).reshape(n, s1 * s2, c), size=k, mode="nearest")
                  .reshape(n, s1, s2, k).permute(0, 3, 1, 2) for h in halves]
        c = k
    planes = [h.reshape(n, 3, c // 3, s1, s2) for h in halves]
    return torch.cat(planes, dim=2).float()


def neighbourhood(points: np.ndarray, r: int, voxel: float) -> np.ndarray:
    """[B, 3] -> [B, (2r+1)^3, 3] cubic neighbourhoods, x slowest."""
    p = np.arange(-r, r + 1)
    off = np.stack([a.reshape(-1) for a in np.meshgrid(p, p, p, indexing="ij")], -1).astype(np.float32)
    return points[:, None, :].astype(np.float32) + voxel * off[None]


def _grids(pts: np.ndarray) -> np.ndarray:
    """[B, K, 3] -> [3, B, K, 2]: (x, y) on the xy plane, (y, z) on yz, (x, z) on xz."""
    return np.stack([pts[..., 0:2], pts[..., 1:3], pts[..., ::2]], 0)


class Handles:
    """One shape's drag request on feature planes of width ``width``."""

    def __init__(self, sources: np.ndarray, targets: np.ndarray, r: int, voxel: float, width: int, device):
        src = neighbourhood(np.asarray(sources, np.float32).reshape(-1, 3), r, voxel)
        tgt = neighbourhood(np.asarray(targets, np.float32).reshape(-1, 3), r, voxel)
        pts = np.concatenate([src.reshape(-1, 3), tgt.reshape(-1, 3)], 0)
        ints = np.clip(np.round((pts + 1.0) * (width - 1) / 2.0).astype(np.int64), 0, width - 1)
        mask = np.ones((3, width, width), np.float32)
        x, y, z = ints[:, 0], ints[:, 1], ints[:, 2]
        mask[0, y, x] = 0.0
        mask[1, z, y] = 0.0
        mask[2, z, x] = 0.0
        self.patch = torch.tensor(_grids(src), device=device)
        self.shift = torch.tensor(_grids(tgt), device=device)
        self.mask = torch.tensor(mask, device=device)
        self.count = float(mask.sum())


def _sample(planes: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """planes [3, C, s, s], grid [3, B, K, 2] -> [3, B, K, C] (bilinear,
    align_corners, zeros outside)."""
    out = F.grid_sample(planes, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def losses(edit: torch.Tensor, origin: torch.Tensor, h: Handles) -> Tuple[torch.Tensor, torch.Tensor]:
    """(motion, mask) of one shape; ``edit``/``origin``: [3, C, s, s]."""
    edit, origin = edit.float(), origin.float()
    c = edit.shape[1]
    patch = _sample(origin, h.patch).detach()
    shift = _sample(edit, h.shift)
    motion = (shift - patch).square().mean()
    mask = ((edit - origin).square() * h.mask[:, None]).sum() / (c * h.count)
    return motion, mask
