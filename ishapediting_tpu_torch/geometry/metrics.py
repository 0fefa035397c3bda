"""Shape-quality metrics: Chamfer, Hausdorff, IoU and the local
handle-region distance (reference: meshProcess.py:18-105), on the host with
NumPy and SciPy, with the JAX package's seeds and sampling calls, so the
same meshes give the same numbers."""

from __future__ import annotations

from typing import Union

import numpy as np
from scipy.spatial import cKDTree

from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.geometry.occupancy import points_occupancy

MeshLike = Union[TriMesh, str]


def _as_mesh(m: MeshLike) -> TriMesh:
    return TriMesh.read(m) if isinstance(m, str) else m


def _nearest(mesh_a: MeshLike, mesh_b: MeshLike, point_num: int, seed: int):
    a = _as_mesh(mesh_a).sample_points_uniformly(point_num, seed=seed)
    b = _as_mesh(mesh_b).sample_points_uniformly(point_num, seed=seed + 1)
    d_ab, _ = cKDTree(a).query(b)
    d_ba, _ = cKDTree(b).query(a)
    return d_ab, d_ba


def chamfer_distance(mesh_a: MeshLike, mesh_b: MeshLike, point_num: int = 100_000, seed: int = 0) -> float:
    """Symmetric squared Chamfer distance between surface samplings
    (reference: meshProcess.py:18-35)."""
    d_ab, d_ba = _nearest(mesh_a, mesh_b, point_num, seed)
    return float(np.mean(np.square(d_ab)) + np.mean(np.square(d_ba)))


def hausdorff_distance(mesh_a: MeshLike, mesh_b: MeshLike, point_num: int = 100_000, seed: int = 0) -> float:
    """Symmetric Hausdorff distance (reference: meshProcess.py:39-56)."""
    d_ab, d_ba = _nearest(mesh_a, mesh_b, point_num, seed)
    return float(max(d_ab.max(), d_ba.max()))


def iou(mesh_a: MeshLike, mesh_b: MeshLike, point_num: int = 100_000, seed: int = 0) -> float:
    """Volumetric IoU on a mixed point set: 20% uniform in [-1,1]^3, 40%
    near surface A and 40% near surface B with sigma 0.01 jitter
    (reference: meshProcess.py:59-77)."""
    ma, mb = _as_mesh(mesh_a), _as_mesh(mesh_b)
    rng = np.random.default_rng(seed)
    uniform = rng.random((int(point_num * 0.2), 3)) * 2 - 1
    pa = ma.sample_points_uniformly(int(point_num * 0.4), seed=seed + 1)
    pa = pa + 0.01 * rng.standard_normal(pa.shape)
    pb = mb.sample_points_uniformly(int(point_num * 0.4), seed=seed + 2)
    pb = pb + 0.01 * rng.standard_normal(pb.shape)
    pts = np.concatenate([uniform, pa, pb], axis=0)
    occ_a = points_occupancy(ma, pts) > 0.5
    occ_b = points_occupancy(mb, pts) > 0.5
    union = (occ_a | occ_b).sum()
    if union == 0:
        return 1.0
    return float((occ_a & occ_b).sum() / union)


def local_distance(
    mesh_a: MeshLike,
    mesh_b: MeshLike,
    points_a: np.ndarray,
    points_b: np.ndarray,
    r: float,
    point_num: int = 20_000,
    metric: str = "IoU",
    seed: int = 0,
) -> float:
    """Local shape agreement in [-r, r]^3 neighbourhoods around paired
    handle points (reference: meshProcess.py:80-105); ``metric`` is "IoU"
    or "L2"."""
    points_a = np.asarray(points_a, np.float64).reshape(-1, 3)
    points_b = np.asarray(points_b, np.float64).reshape(-1, 3)
    if points_a.shape != points_b.shape:
        raise ValueError("points_a and points_b must have the same shape")
    ma, mb = _as_mesh(mesh_a), _as_mesh(mesh_b)
    rng = np.random.default_rng(seed)
    probe = (rng.random((point_num, 3)) * 2 - 1) * r
    total = 0.0
    for i in range(points_a.shape[0]):
        occ_s = points_occupancy(ma, probe + points_a[i]) > 0.5
        occ_t = points_occupancy(mb, probe + points_b[i]) > 0.5
        if metric == "IoU":
            union = (occ_s | occ_t).sum()
            total += float((occ_s & occ_t).sum() / union) if union else 1.0
        elif metric == "L2":
            total += float(np.mean((occ_t.astype(float) - occ_s.astype(float)) ** 2))
        else:
            raise NotImplementedError(metric)
    return total / points_a.shape[0]
