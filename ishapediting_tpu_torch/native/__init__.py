"""Native C++ host geometry (marching tetrahedra, smoothing, OBJ writer,
point-in-mesh occupancy).

The library builds with g++ at first use into ``build/native/`` at the root
of the checkout (a directory ``.gitignore`` lists), never into the package.
The NumPy versions in ``geometry/`` are the executable spec.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_LIB_PATH = os.path.join(BUILD_DIR, "libishape_native.so")
_SRC = os.path.join(_DIR, "native.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_native() -> str:
    """Compile ``native.cpp`` when the library is missing or older than it."""
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_SRC) <= os.path.getmtime(_LIB_PATH):
        return _LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-o", tmp, _SRC],
        check=True, capture_output=True,
    )
    os.replace(tmp, _LIB_PATH)  # atomic: concurrent builders never see half a file
    return _LIB_PATH


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_native())
        dp, lp = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_longlong)
        ll = ctypes.c_longlong
        lib.marching_tets.restype = ll
        lib.marching_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float), ll, ll, ll, ctypes.c_float,
            ctypes.POINTER(dp), ctypes.POINTER(lp),
            ctypes.POINTER(ll), ctypes.POINTER(ll),
        ]
        lib.free_buffers.restype = None
        lib.free_buffers.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.smooth_simple.restype = None
        lib.smooth_simple.argtypes = [dp, ll, lp, ll, ll, dp]
        lib.write_obj.restype = ll
        lib.write_obj.argtypes = [ctypes.c_char_p, dp, ll, lp, ll]
        lib.points_occupancy.restype = None
        lib.points_occupancy.argtypes = [dp, ll, lp, ll, dp, ll, dp]
        _lib = lib
        return lib


def native_marching_tetrahedra(grid: np.ndarray, iso: float = 0.0):
    from ishapediting_tpu_torch.geometry.mesh import TriMesh

    if grid.size > 2**31 - 1:
        # the C++ edge key packs two flat voxel indices into 32 bits each
        raise ValueError(f"grid size {grid.size} exceeds the native 32-bit edge-key bound")
    lib = get_lib()
    g = np.ascontiguousarray(grid, dtype=np.float32)
    verts_ptr = ctypes.POINTER(ctypes.c_double)()
    tris_ptr = ctypes.POINTER(ctypes.c_longlong)()
    nv, nf = ctypes.c_longlong(0), ctypes.c_longlong(0)
    rc = lib.marching_tets(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        g.shape[0], g.shape[1], g.shape[2], ctypes.c_float(iso),
        ctypes.byref(verts_ptr), ctypes.byref(tris_ptr), ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError("native marching_tets failed")
    try:
        verts = np.ctypeslib.as_array(verts_ptr, shape=(nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tris_ptr, shape=(nf.value, 3)).copy()
    finally:
        lib.free_buffers(
            ctypes.cast(verts_ptr, ctypes.c_void_p), ctypes.cast(tris_ptr, ctypes.c_void_p)
        )
    return TriMesh(verts, tris)


def native_smooth_simple(vertices: np.ndarray, triangles: np.ndarray, iterations: int) -> np.ndarray:
    """C++ filter_smooth_simple (unique-neighbor Laplacian); new [n,3] f64 vertices."""
    lib = get_lib()
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    t = np.ascontiguousarray(triangles, dtype=np.int64)
    out = np.empty_like(v)
    lib.smooth_simple(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(t),
        int(iterations), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def native_write_obj(vertices: np.ndarray, triangles: np.ndarray, path: str) -> None:
    """Buffered C++ ascii OBJ writer ("%.8g" vertices, 1-based faces)."""
    lib = get_lib()
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    t = np.ascontiguousarray(triangles, dtype=np.int64)
    rc = lib.write_obj(
        os.fsencode(path),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(t),
    )
    if rc != 0:
        raise OSError(f"native write_obj failed (rc={rc}): {path}")


def native_points_occupancy(vertices: np.ndarray, triangles: np.ndarray, points: np.ndarray) -> np.ndarray:
    """C++ vertical-ray parity test: 1.0 where a point lies inside the
    (watertight) mesh, else 0.0, as [n] f64."""
    lib = get_lib()
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    t = np.ascontiguousarray(triangles, dtype=np.int64)
    p = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 3)
    out = np.zeros(len(p), dtype=np.float64)
    lib.points_occupancy(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(t),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
