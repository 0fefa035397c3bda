"""Triangle-mesh container with the host-side ops the generation and
editing paths need: normalization into [-1, 1]^3, area-uniform surface
sampling, degenerate-triangle removal, Laplacian smoothing and OBJ
input/output (replacing the reference's Open3D TriangleMesh for these)."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # [V, 3] float64
    triangles: np.ndarray  # [F, 3] int64

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float64).reshape(-1, 3)
        self.triangles = np.asarray(self.triangles, dtype=np.int64).reshape(-1, 3)

    def copy(self) -> "TriMesh":
        return TriMesh(self.vertices.copy(), self.triangles.copy())

    def normalize_unit_cube(self, eps: float = 1e-2) -> "TriMesh":
        """Scale/translate into [-1,1]^3 as the reference GUI does on load
        (main.py:425-430, drag_utils.py:418-426): only when out of bounds;
        centered at the vertex mean; scaled only if the extent exceeds 2.
        In place; returns self."""
        mn, mx = self.vertices.min(axis=0), self.vertices.max(axis=0)
        extent = mx - mn
        if np.any(mn < -1) or np.any(mx > 1):
            self.vertices = self.vertices - self.vertices.mean(axis=0)
            if extent.max() > 2:
                self.vertices = self.vertices * (2.0 / (extent.max() + eps))
        return self

    def triangle_areas(self) -> np.ndarray:
        v, t = self.vertices, self.triangles
        cross = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        return 0.5 * np.linalg.norm(cross, axis=1)

    def sample_points_uniformly(self, number_of_points: int, seed: Optional[int] = None) -> np.ndarray:
        """Area-weighted uniform surface sampling -> [N, 3] (Open3D
        sample_points_uniformly), the JAX package's draw order."""
        rng = np.random.default_rng(seed)
        areas = self.triangle_areas()
        idx = rng.choice(len(areas), size=number_of_points, p=areas / areas.sum())
        u = rng.random(number_of_points)
        v = rng.random(number_of_points)
        flip = u + v > 1
        u[flip] = 1 - u[flip]
        v[flip] = 1 - v[flip]
        t = self.triangles[idx]
        a, b, c = (self.vertices[t[:, k]] for k in range(3))
        return a + u[:, None] * (b - a) + v[:, None] * (c - a)

    def remove_degenerate_triangles(self) -> "TriMesh":
        t = self.triangles
        keep = (t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])
        self.triangles = t[keep]
        return self

    def filter_smooth_simple(self, number_of_iterations: int = 1) -> "TriMesh":
        """Laplacian smoothing v' = (v + sum(unique neighbors)) / (1 + deg)
        (Open3D filter_smooth_simple; the reference smooths 10 iterations
        after marching, drag_utils.py:300). Returns a new mesh."""
        if number_of_iterations <= 0:
            return self.copy()
        from ishapediting_tpu_torch.native import native_smooth_simple

        return TriMesh(
            native_smooth_simple(self.vertices, self.triangles, number_of_iterations),
            self.triangles.copy(),
        )

    def write(self, path: str) -> None:
        if os.path.splitext(path)[1].lower() != ".obj":
            raise ValueError(f"unsupported mesh format: {path} (write .obj)")
        from ishapediting_tpu_torch.native import native_write_obj

        native_write_obj(self.vertices, self.triangles, path)

    @staticmethod
    def read(path: str) -> "TriMesh":
        """Read an ascii OBJ (polygons fan-triangulated)."""
        verts, faces = [], []
        with open(path) as f:
            for line in f:
                if line.startswith("v "):
                    verts.append([float(x) for x in line.split()[1:4]])
                elif line.startswith("f "):
                    idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                    for k in range(1, len(idx) - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
        return TriMesh(np.array(verts), np.array(faces))
