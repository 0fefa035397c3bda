"""Triangle-mesh container with the host-side ops the generation, editing
and evaluation paths need, replacing the reference's Open3D TriangleMesh:
bounds and transforms, normalization into [-1, 1]^3, normals and areas,
area-uniform surface sampling, degenerate-triangle removal, Laplacian
smoothing, and input/output in ascii OBJ, OFF, PLY and STL (PLY and STL
also read in binary)."""

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

    # -- bounds / transforms ------------------------------------------------

    @property
    def min_bound(self) -> np.ndarray:
        return self.vertices.min(axis=0)

    @property
    def max_bound(self) -> np.ndarray:
        return self.vertices.max(axis=0)

    @property
    def center(self) -> np.ndarray:
        return self.vertices.mean(axis=0)

    def translate(self, offset: np.ndarray) -> "TriMesh":
        """In place; returns self."""
        self.vertices = self.vertices + np.asarray(offset).reshape(1, 3)
        return self

    def scale(self, factor: float, center: Optional[np.ndarray] = None) -> "TriMesh":
        """Scale about ``center`` (default the origin), in place; returns self."""
        c = np.zeros(3) if center is None else np.asarray(center).reshape(1, 3)
        self.vertices = (self.vertices - c) * factor + c
        return self

    def normalize_unit_cube(self, eps: float = 1e-2) -> "TriMesh":
        """Scale/translate into [-1,1]^3 as the reference GUI does on load
        (main.py:425-430, drag_utils.py:418-426): only when out of bounds;
        centered at the vertex mean; scaled only if the extent exceeds 2.
        In place; returns self."""
        mn, mx = self.min_bound, self.max_bound
        extent = mx - mn
        if np.any(mn < -1) or np.any(mx > 1):
            self.translate(-self.center)
            if extent.max() > 2:
                self.scale(2.0 / (extent.max() + eps))
        return self

    # -- derived quantities -------------------------------------------------

    def triangle_areas(self) -> np.ndarray:
        """``0.5 * |cross(v1 - v0, v2 - v0)|`` per triangle, computed in
        native C++ with NumPy's operations in NumPy's order (bit-equal)."""
        from ishapediting_tpu_torch.native import native_triangle_areas

        return native_triangle_areas(self.vertices, self.triangles)

    def triangle_normals(self) -> np.ndarray:
        v, t = self.vertices, self.triangles
        n = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)

    def vertex_normals(self) -> np.ndarray:
        """Area-weighted mean of the adjacent triangles' normals, unit length."""
        fn = self.triangle_normals() * self.triangle_areas()[:, None]
        vn = np.zeros_like(self.vertices)
        for i in range(3):
            np.add.at(vn, self.triangles[:, i], fn)
        return vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-20)

    def surface_area(self) -> float:
        return float(self.triangle_areas().sum())

    # -- sampling -----------------------------------------------------------

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

    # -- cleanup / smoothing ------------------------------------------------

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

    # -- IO -----------------------------------------------------------------

    def write(self, path: str) -> None:
        """By extension: ascii ``.obj`` (native C++), ``.off``, ``.ply``, ``.stl``."""
        ext = os.path.splitext(path)[1].lower()
        if ext not in _WRITERS:
            raise ValueError(f"unsupported mesh format: {ext}")
        _WRITERS[ext](self, path)

    @staticmethod
    def read(path: str) -> "TriMesh":
        """By extension: ascii ``.obj`` (native C++) and ``.off``; ascii or
        binary ``.ply`` and ``.stl``. Polygons are fan-triangulated."""
        ext = os.path.splitext(path)[1].lower()
        if ext not in _READERS:
            raise ValueError(f"unsupported mesh format: {ext}")
        return _READERS[ext](path)


# ---------------------------------------------------------------------------
# IO backends (ascii obj/off, ascii+binary ply/stl read, ascii write)
# ---------------------------------------------------------------------------


def _write_obj(mesh: TriMesh, path: str) -> None:
    from ishapediting_tpu_torch.native import native_write_obj

    native_write_obj(mesh.vertices, mesh.triangles, path)


def _read_obj(path: str) -> TriMesh:
    from ishapediting_tpu_torch.native import native_read_obj

    return TriMesh(*native_read_obj(path))


def _fan(tokens, pos: int, nf: int):
    """``nf`` polygon records ``cnt i0 i1 ...`` from ``tokens[pos:]``,
    fan-triangulated."""
    faces = []
    for _ in range(nf):
        cnt = int(tokens[pos])
        idx = [int(x) for x in tokens[pos + 1 : pos + 1 + cnt]]
        pos += 1 + cnt
        for k in range(1, cnt - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return np.array(faces)


def _write_off(mesh: TriMesh, path: str) -> None:
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(mesh.vertices)} {len(mesh.triangles)} 0\n")
        for v in mesh.vertices:
            f.write(f"{v[0]:.8g} {v[1]:.8g} {v[2]:.8g}\n")
        for t in mesh.triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def _read_off(path: str) -> TriMesh:
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] not in ("OFF", "COFF"):
        raise ValueError(f"{path}: not an OFF file")
    nv, nf = int(tokens[1]), int(tokens[2])
    verts = np.array(tokens[4 : 4 + 3 * nv], dtype=np.float64).reshape(nv, 3)
    return TriMesh(verts, _fan(tokens, 4 + 3 * nv, nf))


def _write_ply(mesh: TriMesh, path: str) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(mesh.vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(mesh.triangles)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in mesh.vertices:
            f.write(f"{v[0]:.8g} {v[1]:.8g} {v[2]:.8g}\n")
        for t in mesh.triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2",
}


def _read_ply(path: str) -> TriMesh:
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        nv = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
        nf = int(next(l.split()[2] for l in header if l.startswith("element face")))
        vprops = []
        in_vertex = False
        for l in header:
            if l.startswith("element vertex"):
                in_vertex = True
            elif l.startswith("element"):
                in_vertex = False
            elif in_vertex and l.startswith("property"):
                vprops.append(tuple(l.split()[1:]))
        names = [p[1] for p in vprops]
        if fmt == "ascii":
            tokens = f.read().decode("ascii").split()
            stride = len(vprops)
            vdata = np.array(tokens[: stride * nv], dtype=np.float64).reshape(nv, stride)
            verts = vdata[:, [names.index("x"), names.index("y"), names.index("z")]]
            return TriMesh(verts, _fan(tokens, stride * nv, nf))
        endian = "<" if "little" in fmt else ">"
        vdtype = np.dtype([(p[1], endian + _PLY_TYPES[p[0]]) for p in vprops])
        vdata = np.frombuffer(f.read(vdtype.itemsize * nv), dtype=vdtype)
        verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], axis=1).astype(np.float64)
        faces = []
        for _ in range(nf):
            cnt = np.frombuffer(f.read(1), dtype=endian + "u1")[0]
            idx = np.frombuffer(f.read(4 * cnt), dtype=endian + "i4")
            for k in range(1, cnt - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
        return TriMesh(verts, np.array(faces))


def _write_stl(mesh: TriMesh, path: str) -> None:
    normals = mesh.triangle_normals()
    with open(path, "w") as f:
        f.write("solid mesh\n")
        for t, n in zip(mesh.triangles, normals):
            f.write(f"facet normal {n[0]:.8g} {n[1]:.8g} {n[2]:.8g}\n outer loop\n")
            for vi in t:
                v = mesh.vertices[vi]
                f.write(f"  vertex {v[0]:.8g} {v[1]:.8g} {v[2]:.8g}\n")
            f.write(" endloop\nendfacet\n")
        f.write("endsolid mesh\n")


def _read_stl(path: str) -> TriMesh:
    """Ascii or binary STL; identical corners (to 8 decimals) are welded."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            text = f.read().decode("ascii", errors="ignore")
            coords = []
            for line in text.splitlines():
                line = line.strip()
                if line.startswith("vertex"):
                    coords.append([float(x) for x in line.split()[1:4]])
            verts = np.array(coords).reshape(-1, 3)
        else:
            f.seek(80)
            n = int(np.frombuffer(f.read(4), dtype="<u4")[0])
            data = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
            tri = data[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
            verts = tri.reshape(-1, 3).astype(np.float64)
    uniq, inverse = np.unique(verts.round(8), axis=0, return_inverse=True)
    return TriMesh(uniq, inverse.reshape(-1, 3))


_WRITERS = {".obj": _write_obj, ".off": _write_off, ".ply": _write_ply, ".stl": _write_stl}
_READERS = {".obj": _read_obj, ".off": _read_off, ".ply": _read_ply, ".stl": _read_stl}
