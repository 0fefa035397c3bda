"""Marching tetrahedra on the device, as torch ops (counterpart of
``ishapediting_tpu/ops/marching.py::marching_tets_device`` and
``assemble_mesh``).

The occupancy grid stays where it was decoded. Active cells and triangle
slots are compacted with ``torch.nonzero`` (exact counts: eager PyTorch has
no static-shape limit, so there are no capacities to pick), vertices are
welded on the device by an exact integer edge key with ``torch.unique``,
and only the count-sized vertices and triangles are copied to the host.

Semantics are those of the JAX package's device marcher: the host marcher's
6-tetrahedra decomposition and case tables (``geometry/marching.py``,
native C++), the canonical edge direction (lo = the smaller flat grid id),
the same interpolation and clip, and the orientation rule of the NumPy spec
(outward = toward decreasing field, the gradient by ``torch.gradient`` with
``np.gradient``'s one-sided border stencil at the centroid rounded half to
even). The native code weighs a border axis's difference half as much and
rounds ties away from zero, so the two can wind a triangle differently
where its rounded centroid lies on the grid border or on a half-voxel tie.
Interpolation parameters and the orientation test run in fp32, vertices in
fp64 from the welded parameters. Edge keys pack as ``lo * 16 + delta_rank``
in int32, which bounds the grid at 512^3 (the largest key is INT32_MAX).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ishapediting_tpu_torch.geometry.mesh import TriMesh

# Cube corner offsets (i, j, k), standard ordering.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
    dtype=np.int64,
)
# 6-tet decomposition sharing the main diagonal v0-v6.
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]],
    dtype=np.int64,
)
# Local tet edges (pairs of local corner ids 0..3), ids 0..5.
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)
# Triangles per inside-bitmask (bit i set = tet corner i inside), as triples
# of local edge ids; winding is fixed afterwards by the orientation rule.
_CASES = {
    0b0001: [(0, 1, 2)],
    0b0010: [(0, 3, 4)],
    0b0100: [(1, 3, 5)],
    0b1000: [(2, 4, 5)],
    0b0011: [(1, 2, 4), (1, 4, 3)],
    0b0101: [(0, 2, 5), (0, 5, 3)],
    0b1001: [(0, 1, 5), (0, 5, 4)],
    0b0110: [(0, 4, 5), (0, 5, 1)],
    0b1010: [(0, 3, 5), (0, 5, 2)],
    0b1100: [(1, 3, 4), (1, 4, 2)],
    0b0111: [(2, 4, 5)],
    0b1011: [(1, 3, 5)],
    0b1101: [(0, 3, 4)],
    0b1110: [(0, 1, 2)],
}

MAX_RES = 512  # the int32 edge key (corner * 16 + rank) reaches INT32_MAX at 512^3

_NTRI = np.zeros(16, np.int64)
_CASE_TRI = np.zeros((16, 2, 3), np.int64)  # local tet-edge ids, 0-padded
for _code, _tris in _CASES.items():
    _NTRI[_code] = len(_tris)
    for _s, _tri in enumerate(_tris):
        _CASE_TRI[_code, _s] = _tri
# Cube corner (0..7) at each end of the edge of each (tet, case, slot,
# triangle corner), [6, 16, 2, 3].
_TET_IDX = np.arange(6)[:, None, None, None]
_CORNER_A = _TETS[_TET_IDX, _TET_EDGES[_CASE_TRI, 0][None]]
_CORNER_B = _TETS[_TET_IDX, _TET_EDGES[_CASE_TRI, 1][None]]


def _deltas_for_res(res: int) -> np.ndarray:
    """Sorted distinct positive flat-index deltas between tet-edge endpoint
    corners (7 values, so a 4-bit rank packs into the edge key)."""
    strides = np.array([res * res, res, 1], np.int64)
    deltas = {
        int(abs((_CORNERS[tet[lb]] - _CORNERS[tet[la]]) @ strides))
        for tet in _TETS for la, lb in _TET_EDGES
    }
    return np.array(sorted(deltas), np.int64)


def _unflat(f: torch.Tensor, r: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.stack([f // (r * r), (f // r) % r, f % r], dim=-1).to(dtype)


def marching_tets_device(grid: torch.Tensor, iso: float = 0.0) -> Dict[str, object]:
    """Marching tetrahedra over a dense [R, R, R] grid on its own device.

    Returns ``vertices`` [V, 3] fp64 in voxel-index units and ``triangles``
    [F, 3] int64 (wound outward, degenerate ones removed), both on the
    grid's device, and the counts ``n_cells`` (active cells) and ``n_tris``
    (triangles before the degenerate filter) as ints. Intermediates are
    freed as soon as they are used: a 256^3 field of random weights gives
    10^7 triangles, and the per-candidate arrays dominate device memory."""
    r = int(grid.shape[0])
    if tuple(grid.shape) != (r, r, r):
        raise ValueError(f"grid must be [R, R, R], got {tuple(grid.shape)}")
    if r > MAX_RES:
        raise ValueError(
            f"marching_tets_device supports res <= {MAX_RES} (got {r}): the int32 edge key "
            "(corner * 16 + rank) reaches INT32_MAX at 512^3; use geometry.marching beyond that"
        )
    dev = grid.device
    gridf = grid.float().reshape(-1)
    empty = {"vertices": torch.zeros((0, 3), dtype=torch.float64, device=dev),
             "triangles": torch.zeros((0, 3), dtype=torch.int64, device=dev),
             "n_cells": 0, "n_tris": 0}
    if r < 2:
        return empty

    # -- active cells: corner occupancy not constant ------------------------
    occ = (gridf > iso).reshape(r, r, r).to(torch.uint8)
    s = torch.zeros((r - 1, r - 1, r - 1), dtype=torch.uint8, device=dev)
    for dx, dy, dz in _CORNERS:
        s += occ[dx : dx + r - 1, dy : dy + r - 1, dz : dz + r - 1]
    cells = torch.nonzero(((s > 0) & (s < 8)).reshape(-1)).reshape(-1).to(torch.int32)
    del occ, s
    n_cells = int(cells.numel())
    if n_cells == 0:
        return empty
    c1 = r - 1
    base = (cells // (c1 * c1)) * (r * r) + ((cells // c1) % c1) * r + cells % c1  # flat grid id
    del cells
    corner_off = torch.as_tensor(_CORNERS @ np.array([r * r, r, 1]), dtype=torch.int32, device=dev)
    ins = gridf[(base[:, None] + corner_off[None]).long()] > iso  # [K, 8]

    # -- per (cell, tet) case code, slots in cell-major order (cell, tet, slot)
    tets = torch.as_tensor(_TETS, device=dev)
    tin = ins[:, tets].to(torch.int32)  # [K, 6, 4]
    code = tin[..., 0] + 2 * tin[..., 1] + 4 * tin[..., 2] + 8 * tin[..., 3]
    del ins, tin
    ntri = torch.as_tensor(_NTRI, dtype=torch.int32, device=dev)[code]  # [K, 6]
    slots = torch.arange(2, dtype=torch.int32, device=dev)
    tri_idx = torch.nonzero((slots < ntri[..., None]).reshape(-1)).reshape(-1)
    del ntri
    n_tris = int(tri_idx.numel())
    cell_row = tri_idx // 12
    tet = (tri_idx // 2) % 6
    slot = tri_idx % 2
    del tri_idx
    tcode = code.reshape(-1)[(cell_row * 6 + tet)]
    del code
    sel = ((tet * 16 + tcode) * 2 + slot) * 3  # row of the corner tables
    del tcode, slot, tet
    k3 = torch.arange(3, device=dev)
    ca = torch.as_tensor(_CORNER_A.reshape(-1), device=dev)[sel[:, None] + k3]  # [T, 3] corner 0..7
    cb = torch.as_tensor(_CORNER_B.reshape(-1), device=dev)[sel[:, None] + k3]
    del sel
    b_row = base[cell_row][:, None]
    del cell_row, base
    fa = b_row + corner_off[ca]  # [T, 3] flat grid ids (int32)
    fb = b_row + corner_off[cb]
    del b_row, ca, cb
    lo = torch.minimum(fa, fb)  # canonical edge direction: lo = smaller flat id
    hi = torch.maximum(fa, fb)
    del fa, fb

    # -- interpolation, positions for the orientation test (fp32) ------------
    v1 = gridf[lo.long()]
    v2 = gridf[hi.long()]
    denom = v2 - v1
    t = torch.where(
        denom.abs() > 1e-30,
        (iso - v1) / torch.where(denom == 0, torch.ones_like(denom), denom),
        torch.full_like(denom, 0.5),
    ).clamp(0.0, 1.0)
    del v1, v2, denom
    p1 = _unflat(lo, r, torch.float32)
    pos = p1 + t[..., None] * (_unflat(hi, r, torch.float32) - p1)  # [T, 3, 3]
    del p1

    # -- orientation: np.gradient's stencil at the rounded centroid ----------
    idx = torch.round(pos.mean(dim=1)).to(torch.int64).clamp(0, r - 1)
    flat_idx = idx[:, 0] * (r * r) + idx[:, 1] * r + idx[:, 2]
    del idx
    g3 = gridf.reshape(r, r, r)
    grad = torch.stack([d.reshape(-1)[flat_idx] for d in torch.gradient(g3)], dim=-1)
    del flat_idx
    normal = torch.linalg.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    flip = (normal * grad).sum(dim=-1) > 0
    del pos, grad, normal

    # -- edge keys, winding, weld by exact key --------------------------------
    deltas = torch.as_tensor(_deltas_for_res(r), dtype=torch.int32, device=dev)
    keys = lo * 16 + torch.searchsorted(deltas, (hi - lo).contiguous()).to(torch.int32)
    del lo, hi
    swap = torch.tensor([0, 2, 1], device=dev)
    keys = torch.where(flip[:, None], keys[:, swap], keys)
    t = torch.where(flip[:, None], t[:, swap], t)
    del flip
    uniq, inverse = torch.unique(keys.reshape(-1), sorted=True, return_inverse=True)
    del keys
    tv = torch.empty(uniq.numel(), dtype=torch.float32, device=dev)
    tv[inverse] = t.reshape(-1)  # every duplicate of an edge carries the same t
    del t
    ulo = (uniq >> 4).to(torch.int64)
    uhi = ulo + torch.as_tensor(_deltas_for_res(r), device=dev)[(uniq & 15).long()]
    q1 = _unflat(ulo, r, torch.float64)
    vertices = q1 + tv.double()[:, None] * (_unflat(uhi, r, torch.float64) - q1)
    tris = inverse.reshape(-1, 3).to(torch.int64)
    keep = (tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])
    return {"vertices": vertices, "triangles": tris[keep], "n_cells": n_cells, "n_tris": n_tris}


def device_grid_to_mesh(grid: torch.Tensor, iso: float = 0.0, to_unit: bool = True):
    """March ``grid`` where it lies and copy the count-sized mesh to the
    host. Returns ``(TriMesh, stats)``, ``stats`` holding ``march_cells``
    and ``march_tris``; ``to_unit`` maps vertices into [-1, 1]^3 with the
    reference's ``v / res * 2 - 1``."""
    out = marching_tets_device(grid, iso)
    vertices = out["vertices"]
    if to_unit:
        vertices = vertices / grid.shape[0] * 2.0 - 1.0
    mesh = TriMesh(vertices.cpu().numpy(), out["triangles"].cpu().numpy())
    return mesh, {"march_cells": out["n_cells"], "march_tris": out["n_tris"]}
