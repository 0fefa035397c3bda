"""Port parity, the host modules: ``TriMesh``'s geometry and its OBJ/OFF/PLY/STL
input and output, ``signed_distance``, the NumPy marching spec, ARAP, point
cloud reconstruction (with the reference's one-seed normal orientation
pinned), ``decode_points_chunked``, the ``compat`` facade and
``utils/images.py``, each against the JAX package on the same inputs."""

import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu import compat as jcompat
from ishapediting_tpu.geometry import arap as jarap
from ishapediting_tpu.geometry import marching as jmarching
from ishapediting_tpu.geometry import mesh as jmesh
from ishapediting_tpu.geometry import occupancy as jocc
from ishapediting_tpu.geometry import recon as jrecon
from ishapediting_tpu.ops import triplane as jtri
from ishapediting_tpu.utils import images as jimages
from ishapediting_tpu_torch import compat
from ishapediting_tpu_torch.geometry import arap, marching, recon
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.geometry.occupancy import signed_distance
from ishapediting_tpu_torch.ops import triplane
from ishapediting_tpu_torch.utils import images
from torch_parity_helpers import decoder_pair

torch.set_num_threads(2)


def sphere_grid(res=24, r=0.5, center=(0.0, 0.0, 0.0)):
    x = np.linspace(-1, 1, res)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return (r - np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2 + (Z - center[2]) ** 2)).astype(np.float32)


def sphere(res=24, r=0.5):
    return marching.grid_to_mesh(sphere_grid(res, r))


def pair_mesh(seed=0):
    """A smoothed, shifted sphere (irregular, off-center) in both packages."""
    m = sphere(20, 0.6).filter_smooth_simple(2)
    v = m.vertices * np.array([1.3, 0.8, 1.1]) + np.array([0.2, -0.1, 0.4])
    v = v + 0.01 * np.random.default_rng(seed).standard_normal(v.shape)
    return TriMesh(v, m.triangles), jmesh.TriMesh(v.copy(), m.triangles.copy())


# ---------------------------------------------------------------------------
# TriMesh
# ---------------------------------------------------------------------------

METHODS = {
    "min_bound": lambda m: m.min_bound,
    "max_bound": lambda m: m.max_bound,
    "center": lambda m: m.center,
    "translate": lambda m: m.copy().translate(np.array([0.3, -1.2, 2.0])).vertices,
    "scale": lambda m: m.copy().scale(1.7).vertices,
    "scale_about_center": lambda m: m.copy().scale(0.6, center=m.center).vertices,
    "triangle_normals": lambda m: m.triangle_normals(),
    "vertex_normals": lambda m: m.vertex_normals(),
    "surface_area": lambda m: m.surface_area(),
    "triangle_areas": lambda m: m.triangle_areas(),
    "normalize_unit_cube": lambda m: m.copy().normalize_unit_cube().vertices,
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_trimesh_methods_match_jax(name):
    got, want = (METHODS[name](m) for m in pair_mesh())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_native_geometry_split_over_threads_matches_jax(tmp_path):
    """On a mesh large enough that the native loops split over threads
    (about 170k triangles): areas, area-weighted samples, smoothing,
    occupancy and the OBJ bytes equal the JAX package's exactly."""
    from ishapediting_tpu_torch.geometry.occupancy import points_occupancy

    m = sphere(180, 0.8)
    v = m.vertices + 0.002 * np.random.default_rng(0).standard_normal(m.vertices.shape)
    mesh, jm = TriMesh(v, m.triangles), jmesh.TriMesh(v.copy(), m.triangles.copy())
    assert len(mesh.triangles) > 2 * (1 << 16)
    np.testing.assert_array_equal(mesh.triangle_areas(), jm.triangle_areas())
    np.testing.assert_array_equal(mesh.sample_points_uniformly(20_000, seed=3),
                                  jm.sample_points_uniformly(20_000, seed=3))
    np.testing.assert_array_equal(mesh.filter_smooth_simple(3).vertices, jm.filter_smooth_simple(3).vertices)
    pts = np.random.default_rng(1).uniform(-1, 1, (20_000, 3))
    np.testing.assert_array_equal(points_occupancy(mesh, pts), jocc.points_occupancy(jm, pts))
    mesh.write(str(tmp_path / "m.obj"))
    jm.write(str(tmp_path / "j.obj"))
    assert open(tmp_path / "m.obj", "rb").read() == open(tmp_path / "j.obj", "rb").read()


@pytest.mark.parametrize("ext", [".obj", ".off", ".ply", ".stl"])
def test_write_read_round_trip_matches_jax(tmp_path, ext):
    """The port writes; both packages read the same file back to the same
    mesh, and the JAX package's writer gives the same bytes (OBJ: its
    native writer)."""
    mesh, jm = pair_mesh()
    path, jpath = str(tmp_path / f"m{ext}"), str(tmp_path / f"j{ext}")
    mesh.write(path)
    jm.write(jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got, want = TriMesh.read(path), jmesh.TriMesh.read(path)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    assert len(got.triangles) == len(mesh.triangles)
    np.testing.assert_allclose(got.vertices[got.triangles], mesh.vertices[mesh.triangles], atol=1e-7)


def _binary_ply(path, v, f, endian="<"):
    tag = "binary_little_endian" if endian == "<" else "binary_big_endian"
    head = (f"ply\nformat {tag} 1.0\nelement vertex {len(v)}\nproperty float x\nproperty float y\n"
            f"property float z\nproperty uchar red\nelement face {len(f)}\n"
            "property list uchar int vertex_indices\nend_header\n").encode("ascii")
    vd = np.zeros(len(v), dtype=[("x", endian + "f4"), ("y", endian + "f4"), ("z", endian + "f4"), ("r", "u1")])
    vd["x"], vd["y"], vd["z"] = v[:, 0], v[:, 1], v[:, 2]
    body = vd.tobytes()
    for face in f:
        body += struct.pack(endian + "B", len(face)) + np.asarray(face, endian + "i4").tobytes()
    with open(path, "wb") as fh:
        fh.write(head + body)


def _binary_stl(path, v, f):
    data = np.zeros(len(f), dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")])
    data["v"] = v[f]
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80 + struct.pack("<I", len(f)) + data.tobytes())


@pytest.mark.parametrize("kind", ["ply_little", "ply_big", "stl"])
def test_binary_readers_match_jax(tmp_path, kind):
    """Binary PLY (with a quad, fan-triangulated, and an extra vertex
    property) and binary STL (corners welded) read as the JAX package reads
    them."""
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1]], np.float64)
    quads = [[0, 1, 2, 3], [0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]]
    path = str(tmp_path / ("m.stl" if kind == "stl" else "m.ply"))
    if kind == "stl":
        _binary_stl(path, v, np.array([[0, 1, 2], [0, 2, 3], [0, 1, 4], [1, 2, 4]]))
    else:
        _binary_ply(path, v, quads, "<" if kind == "ply_little" else ">")
    got, want = TriMesh.read(path), jmesh.TriMesh.read(path)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    assert len(got.triangles) == (4 if kind == "stl" else 6)


def test_obj_reader_takes_polygons_and_slashed_tokens(tmp_path):
    """The native OBJ reader against the JAX package's Python reader on
    normals, texture lines, four-number vertices, quads and a/b/c tokens."""
    path = str(tmp_path / "poly.obj")
    with open(path, "w") as f:
        f.write("# comment\nv 1 2 3\nvn 0 0 1\nvt 0.5 0.5\nv 4 5 6 1\nv 1e-3 -2.5 7.25\n\n"
                "v 0 0 0\nf 1/1/1 2//2 3 4\nf 4 3 2\r\n")
    got, want = TriMesh.read(path), jmesh.TriMesh.read(path)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    with open(path, "w") as f:
        f.write("v 1 2\n")
    with pytest.raises(ValueError):
        TriMesh.read(path)


def test_unsupported_format_raises(tmp_path):
    with pytest.raises(ValueError):
        pair_mesh()[0].write(str(tmp_path / "m.glb"))
    with pytest.raises(ValueError):
        TriMesh.read(str(tmp_path / "m.glb"))


# ---------------------------------------------------------------------------
# occupancy, marching, ARAP, reconstruction
# ---------------------------------------------------------------------------


def test_signed_distance_matches_jax():
    mesh = sphere(24, 0.5)
    jm = jmesh.TriMesh(mesh.vertices.copy(), mesh.triangles.copy())
    pts = np.random.default_rng(0).uniform(-0.9, 0.9, (3000, 3))
    got = signed_distance(mesh, pts, samples=20_000, seed=3)
    want = jocc.signed_distance(jm, pts, samples=20_000, seed=3)
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    inside = np.linalg.norm(pts, axis=1) < 0.4
    assert (got[inside] < 0).all() and (got[np.linalg.norm(pts, axis=1) > 0.6] > 0).all()


@pytest.mark.parametrize("case", ["sphere", "noise", "empty"])
def test_marching_tetrahedra_matches_jax_spec(case):
    rng = np.random.default_rng(5)
    grid = {
        "sphere": sphere_grid(20, 0.6, (0.1, -0.05, 0.0)),
        "noise": rng.standard_normal((9, 10, 11)).astype(np.float32),
        "empty": -np.ones((6, 6, 6), np.float32),
    }[case]
    got, want = marching.marching_tetrahedra(grid, 0.0), jmarching.marching_tetrahedra(grid, 0.0)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    assert (len(got.triangles) > 0) == (case != "empty")


def test_arap_deform_matches_jax():
    mesh = sphere(16, 0.5)
    v = mesh.vertices
    handle = int(np.argmax(v[:, 0]))
    static = list(np.nonzero(v[:, 0] < -0.3)[0][:30])
    target = v[handle] + np.array([0.3, 0.0, 0.0])
    pos = np.vstack([v[static], target])
    got = arap.arap_deform(mesh, static + [handle], pos, max_iter=10)
    want = jarap.arap_deform(jmesh.TriMesh(v.copy(), mesh.triangles.copy()), static + [handle], pos, max_iter=10)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.vertices[handle], target, atol=1e-6)
    got_c = compat.arap(mesh, static, [handle], [target], max_iter=10)
    np.testing.assert_allclose(got_c.vertices, got.vertices, rtol=0, atol=1e-12)


def torus_cloud(n=6000, seed=0):
    """Points and outward normals of a torus (R 0.5, r 0.2)."""
    rng = np.random.default_rng(seed)
    u, w = rng.uniform(0, 2 * np.pi, n), rng.uniform(0, 2 * np.pi, n)
    ring = np.stack([np.cos(u), np.sin(u), np.zeros(n)], 1)
    normals = ring * np.cos(w)[:, None] + np.array([0, 0, 1.0]) * np.sin(w)[:, None]
    return 0.5 * ring + 0.2 * normals, normals


@pytest.mark.parametrize("method", ["poisson", "knn"])
def test_reconstruction_matches_jax(method):
    pts, normals = torus_cloud()
    kw = dict(resolution=40, smooth_iterations=3, method=method)
    got = recon.point_cloud_to_mesh(pts, normals, **kw)
    want = jrecon.point_cloud_to_mesh(pts, normals, **kw)
    assert len(got.vertices) == len(want.vertices) > 0
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-6)


def test_poisson_reconstruct_matches_jax():
    pts, normals = torus_cloud(seed=1)
    got = recon.poisson_reconstruct(pts, normals, resolution=32, smooth_iterations=0)
    want = jrecon.poisson_reconstruct(pts, normals, resolution=32, smooth_iterations=0)
    assert len(got.vertices) == len(want.vertices) > 0
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-6)


def test_estimate_normals_orients_only_the_seeded_component():
    """Known fault kept from the reference (ROADMAP Queue 3): the MST
    orientation is seeded once, at the highest point, so only that point's
    component of a disconnected kNN graph is oriented outward; the other
    keeps the signs its PCA normals came out with. Pinned, with the JAX
    package's normals to the bit."""
    rng = np.random.default_rng(2)
    d = rng.standard_normal((800, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    high, low = np.array([0.0, 0.0, 2.0]), np.array([0.0, 0.0, -2.0])
    pts = np.concatenate([0.4 * d[:400] + high, 0.4 * d[400:] + low])
    got = recon.estimate_normals(pts, k=12)
    np.testing.assert_array_equal(got, jrecon.estimate_normals(pts, k=12))
    outward = np.einsum("ij,ij->i", got, d) > 0
    assert outward[:400].all()  # the seeded component
    assert 0 < outward[400:].mean() < 1  # the other: signs left as PCA gave them


def test_cloud2mesh_matches_jax(tmp_path):
    pts, normals = torus_cloud(3000, seed=4)
    for root in ("port", "jax"):
        d = tmp_path / root / "cat" / "obj0"
        d.mkdir(parents=True)
        np.savez(d / "pointcloud.npz", points=pts, normals=normals)
    recon.cloud2mesh(str(tmp_path / "port"), resolution=32)
    jrecon.cloud2mesh(str(tmp_path / "jax"), resolution=32)
    for name in ("mesh_origin.obj", "mesh_scale.obj", "mesh_scale_smooth.obj"):
        got = TriMesh.read(str(tmp_path / "port" / "cat" / "obj0" / name))
        want = jmesh.TriMesh.read(str(tmp_path / "jax" / "cat" / "obj0" / name))
        np.testing.assert_array_equal(got.triangles, want.triangles)
        np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-7)


def test_calc_implicit_field_and_points_normals_match_jax():
    mesh = sphere(24, 0.5)
    jm = jmesh.TriMesh(mesh.vertices.copy(), mesh.triangles.copy())
    pts = np.array([[0, 0, 0], [0.9, 0, 0], [0.1, 0.2, -0.1]], float)
    np.testing.assert_array_equal(compat.calc_implicit_field(mesh, pts, sdf=False), [1, 0, 1])
    np.testing.assert_allclose(compat.calc_implicit_field(mesh, pts), jcompat.calc_implicit_field(jm, pts),
                               rtol=0, atol=1e-12)
    pcd = mesh.sample_points_uniformly(256, seed=1)
    got, want = compat.calc_mesh_points_normals(mesh, pcd), jcompat.calc_mesh_points_normals(jm, pcd)
    np.testing.assert_array_equal(got["points"], want["points"])
    np.testing.assert_array_equal(got["normals"], want["normals"])


# ---------------------------------------------------------------------------
# decoding: decode_points_chunked, create_obj, cross_section, noise2shape
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dec_pair():
    return decoder_pair(8, seed=4)


def planes_nchw(seed=0, scale=0.5):
    return (np.random.default_rng(seed).standard_normal((3, 8, 32, 32)) * scale).astype(np.float32)


@pytest.mark.parametrize("n,chunk", [(70_000, 65536), (2500, 1000)])
def test_decode_points_chunked_matches_jax(dec_pair, n, chunk):
    """Past one chunk, the last one partial: the chunk boundary included."""
    jdec, tdec = dec_pair
    planes = planes_nchw().transpose(0, 2, 3, 1).copy()
    coords = np.random.default_rng(1).uniform(-1, 1, (n, 3)).astype(np.float32)
    want = np.asarray(jtri.decode_points_chunked(jdec, jnp.asarray(planes), jnp.asarray(coords), chunk=chunk))
    with torch.no_grad():
        got = triplane.decode_points_chunked(tdec, torch.from_numpy(planes), torch.from_numpy(coords), chunk=chunk)
    assert got.shape == want.shape == (n, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_create_obj_matches_jax(dec_pair, tmp_path):
    """The same occupancy (bf16 decoder MLP in both packages): the occupied
    voxels agree except where |logit| < 1e-4, the grids to 2e-3 (a bf16 ulp
    of the hidden activations; the packages accumulate the bf16 products in
    another order), so the meshes have the same triangles up to winding.
    A vertex interpolates the logits at an edge's ends, and moves by the
    grid's difference over theirs: within 2e-3 for 99.9% of the vertices,
    and within a quarter voxel (2/24/4) where the two ends nearly agree."""
    jdec, tdec = dec_pair
    tri = planes_nchw(0)
    want_grid = np.asarray(jtri.decode_grid(jdec, jnp.asarray(jcompat._planes_to_nhwc(tri)), res=24))
    got_grid = compat.decode_occupancy_grid(tdec, tri, 24)
    np.testing.assert_allclose(got_grid, want_grid, rtol=0, atol=2e-3)
    differ = (got_grid > 0) != (want_grid > 0)
    assert (np.abs(want_grid[differ]) < 1e-4).all()
    assert 0.01 < (want_grid > 0).mean() < 0.99
    got = compat.create_obj(tdec, tri, res=24, output_path=str(tmp_path / "m.obj"))
    want = jcompat.create_obj(jdec, tri, res=24)
    assert os.path.exists(tmp_path / "m.obj")
    assert len(got.vertices) == len(want.vertices) > 0
    np.testing.assert_array_equal(np.sort(got.triangles, axis=1), np.sort(want.triangles, axis=1))
    moved = np.abs(got.vertices - want.vertices).max(axis=1)
    assert np.quantile(moved, 0.999) < 2e-3 and moved.max() < 2 / 24 / 4


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_cross_section_matches_jax(dec_pair, tmp_path, axis):
    """The mask agrees with JAX's except where |logit| < 1e-4; the saved
    image is the mask as a PNG (the reference's matplotlib figure is the
    pinned deviation, ROADMAP Queue 3)."""
    jdec, tdec = dec_pair
    tri = planes_nchw(1)
    got = compat.cross_section(tdec, tri, res=40, axis=axis, save_path=str(tmp_path / "cs.png"))
    want = jcompat.cross_section(jdec, tri, res=40, axis=axis)
    assert got.shape == (40, 40) and got.dtype == np.uint8
    coords = compat.cross_section_coords(40, axis)
    logits = np.asarray(jtri.decode_points(jdec, jnp.asarray(jcompat._planes_to_nhwc(tri)),
                                           jnp.asarray(coords))).reshape(40, 40)
    differ = got != want
    assert (np.abs(logits[differ]) < 1e-4).all()
    assert 0 < got.mean() < 1
    from PIL import Image

    png = np.asarray(Image.open(tmp_path / "cs.png"))
    np.testing.assert_array_equal(png, np.repeat(got[:, :, None] * 255, 3, axis=2))


def test_noise2shape_unnormalizes_engine_samples():
    """Shape [num_samples, H, W, C] with a partial last batch, finite, and
    the engine's normalized samples mapped by x * half_range + middle."""
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.io.model_dir import TriplaneStats
    from ishapediting_tpu_torch.parallel.sampling import sample_batches

    cfg = preset("tiny", 4)
    c = cfg.latent_shape[-1]
    stats = TriplaneStats(half_range=np.linspace(0.5, 2, c).astype(np.float32),
                          middle=np.linspace(-1, 1, c).astype(np.float32))
    engine = DragEngine(cfg, stats=stats, device="cpu")
    out = compat.noise2shape(num_samples=3, batch_size=2, use_ddim=True, seed=5, engine=engine)
    assert out.shape == (3,) + cfg.latent_shape
    assert np.isfinite(out).all()
    norm = sample_batches(engine.sched, engine.model_fn(feat=False), num_samples=3, batch_size=2,
                          latent_shape=cfg.latent_shape, device="cpu", seed=5, sampler="ddim")
    np.testing.assert_allclose(out, norm * stats.half_range + stats.middle, rtol=0, atol=1e-6)
    assert np.abs(norm).max() <= 1.0 + 1e-6 and np.abs(out).max() > 1.0


# ---------------------------------------------------------------------------
# utils/images.py
# ---------------------------------------------------------------------------


def _pngs(path):
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        a = np.zeros((64, 48, 4), np.uint8)
        a[8 + i * 5 : 30 + i, 12:40 - i] = rng.integers(0, 256, (4,), dtype=np.uint8) | 1
        Image.fromarray(a).save(os.path.join(path, f"im{i}.png"))


def _tree(path):
    from PIL import Image

    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            out[os.path.relpath(full, path)] = np.asarray(Image.open(full))
    return out


@pytest.mark.parametrize("fn", ["crop_images_rgba", "crop_images_rgba_each_png", "crop_images_rgba_each_jpg",
                                "down_sample", "png_to_jpg"])
def test_images_match_jax(tmp_path, fn):
    name, _, fmt = fn.partition("_each_")
    name = "crop_images_rgba_each" if fmt else fn
    kw = {"save_format": fmt} if fmt else {}
    for root, mod in (("port", images), ("jax", jimages)):
        _pngs(str(tmp_path / root))
        getattr(mod, name)(str(tmp_path / root), **kw)
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) and len(got) > 3
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_images_need_pillow(tmp_path, monkeypatch):
    """Pillow is imported only when a function runs, with an error that
    names it where it is missing."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        images.png_to_jpg(str(tmp_path))
    with pytest.raises(NotImplementedError):
        monkeypatch.delitem(sys.modules, "PIL")
        images.crop_images_rgba_each(str(tmp_path), save_format="bmp")
