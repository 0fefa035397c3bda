"""Headless mesh rendering (the GUI's save-picture capability without
Open3D; reference: main.py:345-367 renders on a white background).

A z-buffer rasterizer with Lambertian shading, pixel for pixel the JAX
package's (``geometry/render.py``), which rasterizes one triangle per Python
iteration: the projection, shading and drawing order are NumPy here, and
the loop over the triangles' pixels is native C++
(``native.raster_triangles``: the same float64 expressions, the sequential
strict ``<`` z-test, rows split over the host's cores), where a Python
loop over a 256^3 mesh's tens of millions of triangles would take
minutes.

PNGs are written with the standard library (``zlib``, ``struct``); no
imaging package is needed.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from ishapediting_tpu_torch import native
from ishapediting_tpu_torch.geometry.mesh import TriMesh

def _look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def _bbox(lo: np.ndarray, hi: np.ndarray, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-triangle ``int(max(0, lo))`` and ``int(min(size - 1,
    ceil(hi)))``, with values past the image clipped (such a box is empty
    either way) so that they fit an int64."""
    first = np.where(lo > 0, lo, 0.0)
    first = np.floor(np.minimum(first, size)).astype(np.int64)
    c = np.ceil(hi)
    last = np.where(c < size - 1, c, size - 1)
    last = np.maximum(last, -1.0).astype(np.int64)
    return first, last


def render_scene(
    geoms: Sequence[Tuple[np.ndarray, np.ndarray, Optional[Tuple[float, float, float]]]],
    width: int = 512,
    height: int = 512,
    eye: Tuple[float, float, float] = (1.8, 1.4, 1.8),
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0),
    fov_deg: float = 40.0,
    near: float = 0.05,
    far: float = 20.0,
    light_dir: Tuple[float, float, float] = (-1.0, -1.0, -1.0),
    background: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize a list of ``(vertices, triangles, color)`` geometries.

    Returns ``(rgb, depth)``: ``rgb`` uint8 [height, width, 3], ``depth``
    float32 [height, width] normalized to [0, 1] between the ``near`` and
    ``far`` view-space planes and exactly 1.0 where nothing was hit (Open3D's
    ``render_to_depth_image`` contract)."""
    img = np.ones((height, width, 3), np.float64) * np.asarray(background)
    depth_img = np.ones((height, width), np.float32)

    default_color = np.array([0.62, 0.72, 0.85])
    verts, faces, face_colors = [], [], []
    off = 0
    for v, t, c in geoms:
        v = np.asarray(v, np.float64)
        t = np.asarray(t, np.int64)
        if len(v) == 0 or len(t) == 0:
            continue
        verts.append(v)
        faces.append(t + off)
        col = default_color if c is None else np.asarray(c, np.float64)
        face_colors.append(np.broadcast_to(col, (len(t), 3)))
        off += len(v)
    if not verts:
        return (np.clip(img, 0, 1) * 255).astype(np.uint8), depth_img
    v = np.concatenate(verts, axis=0)
    tris = np.concatenate(faces, axis=0)
    base_colors = np.concatenate(face_colors, axis=0)

    view = _look_at(np.asarray(eye, float), np.asarray(center, float), np.asarray(up, float))
    vh = np.concatenate([v, np.ones((len(v), 1))], axis=1) @ view.T
    f = 1.0 / np.tan(np.radians(fov_deg) / 2)
    aspect = width / height
    z = -vh[:, 2]
    zc = np.maximum(z, 1e-9)
    px = (vh[:, 0] * f / (zc * aspect) * 0.5 + 0.5) * (width - 1)
    py = (1.0 - (vh[:, 1] * f / zc * 0.5 + 0.5)) * (height - 1)

    # face shading in world space, double-sided: ambient + diffuse
    n = np.cross(v[tris[:, 1]] - v[tris[:, 0]], v[tris[:, 2]] - v[tris[:, 0]])
    nn = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    ld = -np.asarray(light_dir, float)
    ld = ld / np.linalg.norm(ld)
    shade = 0.25 + 0.75 * np.abs(nn @ ld)

    order = np.argsort(-z[tris].mean(axis=1))  # far first
    to = tris[order]
    xs, ys, zs = px[to], py[to], z[to]  # [F, 3], in drawing order
    x0, x1 = _bbox(xs.min(axis=1), xs.max(axis=1), width)
    y0, y1 = _bbox(ys.min(axis=1), ys.max(axis=1), height)
    d = (ys[:, 1] - ys[:, 2]) * (xs[:, 0] - xs[:, 2]) + (xs[:, 2] - xs[:, 1]) * (ys[:, 0] - ys[:, 2])
    keep = ~np.any(zs <= 1e-9, axis=1) & (x0 <= x1) & (y0 <= y1) & ~(np.abs(d) < 1e-12)
    kept = np.nonzero(keep)[0]
    colors = base_colors[order] * shade[order][:, None]

    zbuf = np.full(height * width, np.inf)
    rgb = img.reshape(-1, 3)
    native.raster_triangles(xs, ys, zs, x0, x1, y0, y1, d, kept, colors, zbuf, rgb, width)

    zbuf = zbuf.reshape(height, width)
    hit = np.isfinite(zbuf)
    depth_img[hit] = np.clip((zbuf[hit] - near) / max(far - near, 1e-9), 0.0, 1.0 - 1e-6)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), depth_img


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` [H, W, 3] uint8, written with ``zlib``."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of a PNG as ``write_png`` writes it (8-bit RGB, no
    interlace, filter 0 on every row); raises ``ValueError`` on any other."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def render_mesh(
    mesh: TriMesh,
    size: int = 512,
    eye: Tuple[float, float, float] = (1.8, 1.4, 1.8),
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0),
    fov_deg: float = 40.0,
    color: Tuple[float, float, float] = (0.62, 0.72, 0.85),
    light_dir: Tuple[float, float, float] = (-1.0, -1.0, -1.0),
    background: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    save_path: Optional[str] = None,
) -> np.ndarray:
    """Rasterize ``mesh`` to an RGB uint8 image [size, size, 3]; with
    ``save_path`` also write it as a PNG."""
    out, _ = render_scene(
        [(np.asarray(mesh.vertices), np.asarray(mesh.triangles), color)],
        width=size, height=size, eye=eye, center=center, up=up, fov_deg=fov_deg,
        light_dir=light_dir, background=background,
    )
    if save_path:
        write_png(save_path, out)
    return out
