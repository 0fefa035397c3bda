"""Isosurface extraction by marching tetrahedra on the host (native C++).

Replaces PyMCubes' ``mcubes.marching_cubes(grid, 0)`` in the reference mesh
path (reference: visualize.py:76-105) with the 6-tetrahedra cube
decomposition: vertices on grid-edge crossings, welded by edge id,
triangles oriented outward (toward decreasing field).
"""

from __future__ import annotations

import numpy as np

from ishapediting_tpu_torch.geometry.mesh import TriMesh


def grid_to_mesh(grid: np.ndarray, iso: float = 0.0, to_unit: bool = True) -> TriMesh:
    """Extract the ``grid > iso`` surface of a [R, R, R] field and map
    vertices into [-1, 1]^3 with the reference's ``v / res * 2 - 1``
    (visualize.py:101)."""
    from ishapediting_tpu_torch.native import native_marching_tetrahedra

    mesh = native_marching_tetrahedra(np.asarray(grid), iso).remove_degenerate_triangles()
    if to_unit:
        mesh.vertices = mesh.vertices / grid.shape[0] * 2.0 - 1.0
    return mesh
