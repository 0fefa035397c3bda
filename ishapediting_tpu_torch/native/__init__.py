"""Native C++ host geometry (marching tetrahedra, smoothing, triangle
areas, OBJ writer and reader, point-in-mesh occupancy), the renderer's
z-buffer loop (``raster_triangles``), and the orbax reader's zstd decoder
and CRC-32C (``zstd_decompress``, ``crc32c``). Smoothing, areas
and occupancy split their loops over the host's cores (``std::thread``,
joined before each call returns); their results do not depend on it.

The library builds with g++ at first use into ``build/native/`` at the root
of the checkout (a directory ``.gitignore`` lists), never into the package.
The NumPy versions in ``geometry/`` are the executable spec.
"""

from __future__ import annotations

import ctypes
import fcntl
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
    """Compile ``native.cpp`` when the library is missing or older than it.
    Processes that start together build once: the others wait on a file
    lock, then find the library up to date."""

    def up_to_date():
        return os.path.exists(_LIB_PATH) and os.path.getmtime(_SRC) <= os.path.getmtime(_LIB_PATH)

    if up_to_date():
        return _LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or the process dies
        if not up_to_date():
            tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread", "-o", tmp, _SRC],
                check=True, capture_output=True,
            )
            os.replace(tmp, _LIB_PATH)  # atomic: a reader never sees half a file
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
        lib.read_obj.restype = ll
        lib.read_obj.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(dp), ctypes.POINTER(lp),
            ctypes.POINTER(ll), ctypes.POINTER(ll),
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.zstd_decompress.restype = ll
        lib.zstd_decompress.argtypes = [ctypes.c_char_p, ll, ctypes.POINTER(u8p), ctypes.POINTER(ll),
                                        ctypes.c_char_p, ll]
        lib.raster_triangles.restype = None
        lib.raster_triangles.argtypes = [dp, dp, dp, lp, lp, lp, lp, dp, lp, ll, dp, ll, ll, dp, dp]
        lib.crc32c.restype = ctypes.c_uint32
        lib.crc32c.argtypes = [ctypes.c_char_p, ll]
        lib.points_occupancy.restype = None
        lib.points_occupancy.argtypes = [dp, ll, lp, ll, dp, ll, dp]
        lib.triangle_areas.restype = None
        lib.triangle_areas.argtypes = [dp, lp, ll, dp]
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


def native_triangle_areas(vertices: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """C++ per-triangle areas, bit-equal to ``0.5 * np.linalg.norm(np.cross(
    v1 - v0, v2 - v0), axis=1)``; [F] f64."""
    lib = get_lib()
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    t = np.ascontiguousarray(triangles, dtype=np.int64)
    out = np.empty(len(t), np.float64)
    lib.triangle_areas(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(t),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
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


def native_read_obj(path: str):
    """C++ ascii OBJ reader -> ([V, 3] f64 vertices, [F, 3] int64 triangles):
    "v" and "f" lines, first index of each face token, polygons
    fan-triangulated."""
    lib = get_lib()
    verts_ptr = ctypes.POINTER(ctypes.c_double)()
    tris_ptr = ctypes.POINTER(ctypes.c_longlong)()
    nv, nf = ctypes.c_longlong(0), ctypes.c_longlong(0)
    rc = lib.read_obj(
        os.fsencode(path), ctypes.byref(verts_ptr), ctypes.byref(tris_ptr),
        ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc == 1:
        raise OSError(f"native read_obj could not read {path}")
    if rc != 0:
        raise ValueError(f"{path}: malformed OBJ (a 'v' line with fewer than 3 numbers "
                         "or a non-integer face index)")
    try:
        verts = np.ctypeslib.as_array(verts_ptr, shape=(nv.value * 3,)).reshape(-1, 3).copy()
        tris = np.ctypeslib.as_array(tris_ptr, shape=(nf.value * 3,)).reshape(-1, 3).copy()
    finally:
        lib.free_buffers(
            ctypes.cast(verts_ptr, ctypes.c_void_p), ctypes.cast(tris_ptr, ctypes.c_void_p)
        )
    return verts, tris


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


def zstd_decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data`` (RFC 8878; skippable
    frames skipped, content checksums verified). Raises ``ValueError`` on
    input that is not valid zstd, or that names a dictionary."""
    lib = get_lib()
    data = bytes(data)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_longlong()
    err = ctypes.create_string_buffer(256)
    if lib.zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(n), err, len(err)):
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.free_buffers(out, None)


def raster_triangles(xs, ys, zs, x0, x1, y0, y1, d, kept, colors, zbuf, rgb, width: int) -> None:
    """``geometry/render.py``'s z-buffer loop: triangles ``kept`` (indices
    into the drawing-order arrays: screen ``xs``, ``ys`` and depths ``zs``
    [F, 3], pixel boxes ``x0..x1`` x ``y0..y1``, edge determinants ``d``,
    ``colors`` [F, 3]) drawn into ``zbuf`` [H*W] and ``rgb`` [H*W, 3], in
    place (float64 and int64, C order)."""
    lib = get_lib()
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    lptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))  # noqa: E731
    arrays = [np.ascontiguousarray(a, np.float64) for a in (xs, ys, zs, d, colors)]
    boxes = [np.ascontiguousarray(a, np.int64) for a in (x0, x1, y0, y1, kept)]
    for out in (zbuf, rgb):
        if out.dtype != np.float64 or not out.flags.c_contiguous:
            raise ValueError("zbuf and rgb must be C-contiguous float64")
    xs, ys, zs, d, colors = arrays
    x0, x1, y0, y1, kept = boxes
    lib.raster_triangles(dptr(xs), dptr(ys), dptr(zs), lptr(x0), lptr(x1), lptr(y0), lptr(y1), dptr(d),
                         lptr(kept), len(kept), dptr(colors), int(width), len(zbuf) // int(width),
                         dptr(zbuf), dptr(rgb))


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    data = bytes(data)
    return int(get_lib().crc32c(data, len(data)))
