"""Point-in-mesh occupancy and signed distance on the host (replaces
Open3D's RaycastingScene, reference: meshProcess.py:7-14), for labeling the
sample points of the real-shape fit (reference: drag_utils.py:431-437) and
for the IoU metrics: a vertical-ray parity test with a 2D grid accelerator,
in native C++."""

from __future__ import annotations

import numpy as np

from ishapediting_tpu_torch.geometry.mesh import TriMesh


def points_occupancy(mesh: TriMesh, points: np.ndarray) -> np.ndarray:
    """1.0 where the point is inside the (watertight) mesh, else 0.0
    (``RaycastingScene.compute_occupancy`` semantics, reference:
    meshProcess.py:14)."""
    from ishapediting_tpu_torch.native import native_points_occupancy

    return native_points_occupancy(mesh.vertices, mesh.triangles, np.asarray(points, np.float64))


def signed_distance(mesh: TriMesh, points: np.ndarray, samples: int = 200_000, seed: int = 0) -> np.ndarray:
    """Approximate signed distance: unsigned distance to a dense surface
    sampling (cKDTree) with the occupancy parity sign (negative inside).

    The reference uses Open3D's exact signed distance (meshProcess.py:12);
    for the metrics that consume it (IoU inside-tests, reference
    meshProcess.py:72-77) only the sign matters, which is exact here. The
    magnitude is accurate to the sampling density."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    surf = mesh.sample_points_uniformly(samples, seed=seed)
    dist, _ = cKDTree(surf).query(pts)
    return np.where(points_occupancy(mesh, pts) > 0.5, -dist, dist)
