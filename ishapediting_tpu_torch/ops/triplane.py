"""Triplane occupancy decoder: Fourier features + MLP over plane sums.

Rebuilds MultiTriplane (reference: axisnetworks.py:517-562): the feature at
a 3D point is the sum of bilinear samples of three 32-channel planes (xy,
yz, xz), pushed through FourierFeatureTransform(32 -> 64, scale=1) and a
128-128-1 ReLU MLP producing an occupancy logit.

- ``decode_points``: arbitrary point sets (gather-based grid sampling),
  differentiable w.r.t. the planes; ``decode_points_chunked`` for large
  sets, in fixed chunks.
- ``decode_grid``: the dense res^3 sweep. On a lattice, plane sampling is a
  separable align-corners resize of each plane, and the Fourier projection is
  linear, so both run per plane pixel; the per-voxel sin/cos come from the
  per-plane sin/cos by angle addition in fp32, and only the MLP matmuls run
  in ``compute_dtype``. Rows are decoded in chunks into a preallocated grid.

Plane k stores value[row, col] with (row, col) = (y, x) / (z, y) / (z, x)
for k = 0 (xy) / 1 (yz) / 2 (xz).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ishapediting_tpu_torch.ops.grid_sample import grid_sample_2d
from ishapediting_tpu_torch.ops.nn import linear


class FourierFeatures(nn.Module):
    """FourierFeatureTransform's fixed projection ``_B`` [in, mapping]
    (reference: axisnetworks.py:76-90)."""

    def __init__(self, in_channels: int = 32, mapping: int = 64):
        super().__init__()
        self._B = nn.Parameter(torch.randn(in_channels, mapping), requires_grad=False)


class TriplaneDecoder(nn.Sequential):
    """The decoder MLP with the reference's ``net`` state_dict keys
    (``0._B``, ``1/3/5.weight|bias``). Evaluate it with ``decode_points`` or
    ``decode_grid``."""

    def __init__(self, in_channels: int = 32, mapping: int = 64, hidden: int = 128, out_dim: int = 1):
        super().__init__(
            FourierFeatures(in_channels, mapping),
            nn.Linear(2 * mapping, hidden),
            nn.ReLU(),
            nn.Linear(hidden, hidden),
            nn.ReLU(),
            nn.Linear(hidden, out_dim),
        )

    @property
    def fourier_B(self) -> torch.Tensor:
        return self[0]._B


@torch.no_grad()
def init_decoder_(dec: TriplaneDecoder, generator: torch.Generator) -> TriplaneDecoder:
    """Random decoder with the JAX package's distributions: B ~ N(0, 1),
    dense weights and biases U(+-1/sqrt(fan_in))."""
    dev = dec.fourier_B.device
    dec.fourier_B.copy_(torch.randn(dec.fourier_B.shape, generator=generator, device=dev))
    for idx in (1, 3, 5):
        lin = dec[idx]
        bound = 1.0 / math.sqrt(lin.in_features)
        for p in (lin.weight, lin.bias):
            p.copy_((torch.rand(p.shape, generator=generator, device=dev) * 2 - 1) * bound)
    return dec


def _mlp_from_sincos(dec: TriplaneDecoder, sin_x, cos_x, compute_dtype) -> torch.Tensor:
    """The MLP torso on precomputed sin/cos features; fp32 logits."""
    h = torch.cat([sin_x, cos_x], dim=-1).to(compute_dtype)
    h = torch.relu(linear(h, dec[1].weight, dec[1].bias))
    h = torch.relu(linear(h, dec[3].weight, dec[3].bias))
    return linear(h, dec[5].weight, dec[5].bias).float()


def mlp_head(dec: TriplaneDecoder, fourier_proj: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """sin/cos + MLP on an already-projected feature (feat @ B): 2*pi, then
    concat(sin, cos) (reference: axisnetworks.py:86-90). Phases and sin/cos
    are fp32; only the MLP matmuls run in ``compute_dtype``."""
    x = 2.0 * np.pi * fourier_proj.float()
    return _mlp_from_sincos(dec, torch.sin(x), torch.cos(x), compute_dtype)


def sample_plane_features(planes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sum of bilinear plane samples (reference: axisnetworks.py:546-559).
    planes [3, H, W, C] (xy, yz, xz); coords [N, 3] in [-1, 1]^3 -> [N, C]."""
    grids = torch.stack([coords[:, 0:2], coords[:, 1:3], coords[:, [0, 2]]], dim=0)
    return grid_sample_2d(planes, grids).sum(dim=0)


def decode_points(dec: TriplaneDecoder, planes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Occupancy logits at arbitrary points, [N, 3] -> [N, out_dim]."""
    feats = sample_plane_features(planes, coords)
    return mlp_head(dec, feats @ dec.fourier_B)


def decode_points_chunked(
    dec: TriplaneDecoder, planes: torch.Tensor, coords: torch.Tensor, chunk: int = 65536
) -> torch.Tensor:
    """``decode_points`` over a large point set, ``chunk`` points at a time,
    on the planes' device: [N, 3] -> [N, out_dim]."""
    coords = torch.as_tensor(coords, dtype=torch.float32).to(planes.device)
    return torch.cat([decode_points(dec, planes, c) for c in torch.split(coords, chunk)], dim=0)


def _resize_matrix_align_corners(src: int, dst: int) -> np.ndarray:
    """[dst, src] bilinear interpolation matrix with align_corners=True:
    output i samples source position i*(src-1)/(dst-1)."""
    if dst == 1:
        m = np.zeros((1, src), np.float32)
        m[0, 0] = 1.0
        return m
    pos = np.arange(dst, dtype=np.float64) * (src - 1) / (dst - 1)
    i0 = np.minimum(np.floor(pos).astype(np.int64), src - 2)
    w1 = pos - i0
    m = np.zeros((dst, src), np.float64)
    m[np.arange(dst), i0] = 1.0 - w1
    m[np.arange(dst), i0 + 1] += w1
    return m.astype(np.float32)


def _grid_precompute(dec: TriplaneDecoder, planes: torch.Tensor, res: int):
    """Per-plane-pixel work shared by every grid row: the align-corners
    resize of each plane to res x res, the Fourier projection folded in, and
    sin/cos of 2*pi*proj per plane pixel, all fp32. Returns six
    [res, res, mapping] arrays (sin, cos for xy, yz, xz)."""
    _, h, _, _ = planes.shape
    m = torch.from_numpy(_resize_matrix_align_corners(h, res)).to(planes.device)
    rp = torch.einsum("rh,phwc->prwc", m, planes.float())
    rp = torch.einsum("sw,prwc->prsc", m, rp)  # [3, res(row), res(col), C]
    proj = torch.einsum("prsc,cm->prsm", rp, dec.fourier_B.float())
    phase = (2.0 * np.pi) * proj
    sin_p, cos_p = torch.sin(phase), torch.cos(phase)
    return sin_p[0], cos_p[0], sin_p[1], cos_p[1], sin_p[2], cos_p[2]


def _grid_rows(dec, pre, i0: int, ic: int, compute_dtype) -> torch.Tensor:
    """Logits of x-rows [i0, i0+ic): [ic, res, res] indexed [i, j, k].
    Phase[i, k, j] = A[j, i] + B[k, j] + G[k, i]; its sin/cos by angle
    addition on the per-plane sin/cos."""
    s_xy, c_xy, s_yz, c_yz, s_xz, c_xz = pre
    sa = s_xy[:, i0 : i0 + ic].transpose(0, 1)[:, None]  # [ic, 1, j, m]
    ca = c_xy[:, i0 : i0 + ic].transpose(0, 1)[:, None]
    sb, cb = s_yz[None], c_yz[None]  # [1, k, j, m]
    sg = s_xz[:, i0 : i0 + ic].transpose(0, 1)[:, :, None]  # [ic, k, 1, m]
    cg = c_xz[:, i0 : i0 + ic].transpose(0, 1)[:, :, None]
    s_ab = sa * cb + ca * sb
    c_ab = ca * cb - sa * sb
    sin3 = s_ab * cg + c_ab * sg
    cos3 = c_ab * cg - s_ab * sg
    logits = _mlp_from_sincos(dec, sin3, cos3, compute_dtype)[..., 0]
    return logits.transpose(1, 2)  # [ic, j, k]


@torch.no_grad()
def decode_grid(
    dec: TriplaneDecoder,
    planes: torch.Tensor,
    *,
    res: int = 256,
    chunk: int = 16,
    compute_dtype: torch.dtype = torch.bfloat16,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Dense occupancy logits [res, res, res], indexed [i, j, k] for
    (x, y, z) = linspace(-1, 1, res) (reference: visualize.py:79-97),
    written chunk by chunk into a grid of ``out_dtype`` (default fp32)."""
    pre = _grid_precompute(dec, planes, res)
    while res % chunk:  # largest divisor of res not exceeding the request
        chunk -= 1
    grid = torch.empty((res, res, res), dtype=out_dtype or torch.float32, device=planes.device)
    for i0 in range(0, res, chunk):
        grid[i0 : i0 + chunk] = _grid_rows(dec, pre, i0, chunk, compute_dtype)
    return grid


def tv_reg(planes: torch.Tensor) -> torch.Tensor:
    """Total-variation regularizer (reference: axisnetworks.py:564-569): per
    plane, the root of the summed squared neighbour differences along each
    axis, summed."""
    total = 0.0
    for axis in (1, 2):
        d = torch.diff(planes, dim=axis)
        total = total + torch.sqrt(d.square().sum(dim=(1, 2, 3)))
    return total.sum()


def l2_reg(planes: torch.Tensor) -> torch.Tensor:
    """L2 regularizer (reference: axisnetworks.py:571-575): the sum over
    planes of each plane's norm."""
    return torch.sqrt(planes.square().sum(dim=(1, 2, 3))).sum()
