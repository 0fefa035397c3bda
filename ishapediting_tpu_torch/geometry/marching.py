"""Isosurface extraction by marching tetrahedra on the host.

Replaces PyMCubes' ``mcubes.marching_cubes(grid, 0)`` in the reference mesh
path (reference: visualize.py:76-105) with the 6-tetrahedra cube
decomposition: vertices on grid-edge crossings, welded by edge id,
triangles oriented outward (toward decreasing field).

``grid_to_mesh`` marches in native C++ (and raises where that library
fails). ``marching_tetrahedra`` is the same algorithm in NumPy, the
executable spec that the native and device marchers are held to; no path
falls back to it.
"""

from __future__ import annotations

import numpy as np

from ishapediting_tpu_torch.geometry.mesh import TriMesh

# Cube corner offsets, standard ordering.
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
# of local edge ids. Winding is fixed globally afterwards.
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


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0) -> TriMesh:
    """The ``grid > iso`` surface of a dense [R0, R1, R2] field, with
    vertices in voxel-index coordinates, degenerate triangles removed."""
    grid = np.asarray(grid, dtype=np.float64)
    r0, r1, r2 = grid.shape
    inside = grid > iso

    # active cubes: corner occupancy not constant over the 8 corners
    occ = inside.astype(np.uint8)
    s = np.zeros((r0 - 1, r1 - 1, r2 - 1), np.uint8)
    for dx, dy, dz in _CORNERS:
        s += occ[dx : dx + r0 - 1, dy : dy + r1 - 1, dz : dz + r2 - 1]
    ci, cj, ck = np.nonzero((s > 0) & (s < 8))
    if len(ci) == 0:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    base = np.stack([ci, cj, ck], axis=1)  # [M, 3]

    # global flat ids and values of the 8 corners of each active cube
    corner_idx = base[:, None, :] + _CORNERS[None, :, :]  # [M, 8, 3]
    flat = corner_idx[..., 0] * (r1 * r2) + corner_idx[..., 1] * r2 + corner_idx[..., 2]
    vals = grid.reshape(-1)[flat]  # [M, 8]
    ins = vals > iso

    tri_edge_a, tri_edge_b = [], []  # flat grid ids of each edge's endpoints
    for tet in _TETS:
        tins = ins[:, tet]
        code = tins[:, 0].astype(np.int64) + tins[:, 1] * 2 + tins[:, 2] * 4 + tins[:, 3] * 8
        tflat = flat[:, tet]  # [M, 4]
        for c, tris in _CASES.items():
            sel = np.nonzero(code == c)[0]
            if len(sel) == 0:
                continue
            for tri in tris:
                ea = np.empty((len(sel), 3), np.int64)
                eb = np.empty((len(sel), 3), np.int64)
                for k, eid in enumerate(tri):
                    la, lb = _TET_EDGES[eid]
                    ea[:, k] = tflat[sel, la]
                    eb[:, k] = tflat[sel, lb]
                tri_edge_a.append(ea)
                tri_edge_b.append(eb)

    ea = np.concatenate(tri_edge_a, axis=0)  # [T, 3]
    eb = np.concatenate(tri_edge_b, axis=0)
    n = r0 * r1 * r2
    keys = np.minimum(ea, eb) * n + np.maximum(ea, eb)  # canonical edge (lo, hi)
    uniq, inverse = np.unique(keys, return_inverse=True)
    triangles = inverse.reshape(-1, 3)

    # one vertex per unique edge, linearly interpolated
    ulo, uhi = uniq // n, uniq % n
    v1, v2 = grid.reshape(-1)[ulo], grid.reshape(-1)[uhi]
    denom = v2 - v1
    t = np.where(np.abs(denom) > 1e-30, (iso - v1) / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)

    def unflat(f):
        return np.stack([f // (r1 * r2), (f // r2) % r1, f % r2], axis=1).astype(np.float64)

    p1, p2 = unflat(ulo), unflat(uhi)
    mesh = TriMesh(p1 + t[:, None] * (p2 - p1), triangles)
    _orient_outward(mesh, grid)
    return mesh.remove_degenerate_triangles()


def _orient_outward(mesh: TriMesh, grid: np.ndarray) -> None:
    """Flip triangles so normals point toward decreasing field (outside)."""
    if len(mesh.triangles) == 0:
        return
    g = np.stack(np.gradient(grid), axis=-1)  # [R0, R1, R2, 3]
    v, t = mesh.vertices, mesh.triangles
    centroid = v[t].mean(axis=1)
    idx = np.clip(np.round(centroid).astype(np.int64), 0, np.array(grid.shape) - 1)
    grad = g[idx[:, 0], idx[:, 1], idx[:, 2]]
    normal = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    flip = np.einsum("ij,ij->i", normal, grad) > 0
    t[flip] = t[flip][:, [0, 2, 1]]


def grid_to_mesh(grid: np.ndarray, iso: float = 0.0, to_unit: bool = True) -> TriMesh:
    """Extract the ``grid > iso`` surface of a [R, R, R] field and map
    vertices into [-1, 1]^3 with the reference's ``v / res * 2 - 1``
    (visualize.py:101)."""
    from ishapediting_tpu_torch.native import native_marching_tetrahedra

    mesh = native_marching_tetrahedra(np.asarray(grid), iso).remove_degenerate_triangles()
    if to_unit:
        mesh.vertices = mesh.vertices / grid.shape[0] * 2.0 - 1.0
    return mesh
