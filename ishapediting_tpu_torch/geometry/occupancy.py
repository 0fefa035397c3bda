"""Point-in-mesh occupancy on the host (replaces Open3D's RaycastingScene,
reference: meshProcess.py:7-14), for labeling the sample points of the
real-shape fit (reference: drag_utils.py:431-437): a vertical-ray parity
test with a 2D grid accelerator, in native C++."""

from __future__ import annotations

import numpy as np

from ishapediting_tpu_torch.geometry.mesh import TriMesh


def points_occupancy(mesh: TriMesh, points: np.ndarray) -> np.ndarray:
    """1.0 where the point is inside the (watertight) mesh, else 0.0
    (``RaycastingScene.compute_occupancy`` semantics, reference:
    meshProcess.py:14)."""
    from ishapediting_tpu_torch.native import native_points_occupancy

    return native_points_occupancy(mesh.vertices, mesh.triangles, np.asarray(points, np.float64))
