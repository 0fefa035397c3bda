"""Triangle-mesh container with the host-side ops the generation path needs:
degenerate-triangle removal, Laplacian smoothing and OBJ input/output
(replacing the reference's Open3D TriangleMesh for these)."""

from __future__ import annotations

import dataclasses
import os

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
