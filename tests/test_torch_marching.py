"""Port parity, device marching (``ishapediting_tpu_torch/ops/marching.py``)
on CPU tensors: against the JAX package's ``marching_tets_device`` +
``assemble_mesh`` (the same edge keys, so the same vertex and triangle order),
against the port's host marcher (native C++, fp64), and through
``DragEngine.get_mesh``'s device branch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from ishapediting_tpu.ops.marching import assemble_mesh
from ishapediting_tpu.ops.marching import marching_tets_device as j_marching_tets_device
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from ishapediting_tpu_torch.ops.marching import device_grid_to_mesh, marching_tets_device

torch.set_num_threads(2)


def sphere_grid(res):
    x = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return (0.6 - np.sqrt(X**2 + Y**2 + Z**2)).astype(np.float32)


def blob_grid(res, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    g = 0.4 - np.sqrt(X**2 + 1.2 * Y**2 + 0.8 * Z**2)
    g = g + 0.06 * np.sin(5 * X + rng.uniform(0, 1)) * np.cos(4 * Y)
    return g.astype(np.float32)


def noisy_grid(res, seed=1, border=0):
    """A random field (many small components), like a decoder of random
    weights: the stress case of the weld and the orientation rule. With
    ``border`` > 0 that many layers on each face are outside."""
    g = np.random.default_rng(seed).normal(size=(res, res, res)).astype(np.float32)
    if border:
        inner = g[border:-border, border:-border, border:-border].copy()
        g[:] = -1.0
        g[border:-border, border:-border, border:-border] = inner
    return g


GRIDS = {
    "sphere16": lambda: sphere_grid(16),
    "blob24": lambda: blob_grid(24),
    "blob48": lambda: blob_grid(48),
    "noisy20": lambda: noisy_grid(20),
    "noisy32_inner": lambda: noisy_grid(32, seed=2, border=2),
}
# Surfaces that keep off the grid's border layers (see
# test_border_orientation_follows_np_gradient for the border).
INTERIOR = ["sphere16", "blob24", "blob48", "noisy32_inner"]


def signatures(mesh):
    """Per-triangle centroid + area: independent of vertex order and winding."""
    v, t = mesh.vertices, mesh.triangles
    area = 0.5 * np.linalg.norm(np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]]), axis=1)
    return np.concatenate([v[t].mean(axis=1), area[:, None]], axis=1)


def assert_same_triangles(a, b, atol):
    sa, sb = signatures(a), signatures(b)
    assert len(sa) == len(sb)
    assert cKDTree(sb).query(sa)[0].max() < atol
    assert cKDTree(sa).query(sb)[0].max() < atol


def signed_volume(mesh):
    v, t = mesh.vertices, mesh.triangles
    return float(np.einsum("ij,ij->", v[t[:, 0]], np.cross(v[t[:, 1]], v[t[:, 2]]))) / 6.0


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_matches_jax_device_marching(name):
    """Same edge keys as JAX, so the welded vertices come out in the same
    (key) order and the triangles in the same (cell, tet, slot) order:
    triangles equal exactly, vertices to 1e-6 voxel (both interpolate in
    fp32; JAX's t here is unpacked, not the fp16 transfer form)."""
    grid = GRIDS[name]()
    r = grid.shape[0]
    cells = (r - 1) ** 3  # every cell: JAX's fixed capacities never overflow here
    j = j_marching_tets_device(jnp.asarray(grid), 0.0, max_cells=cells, max_tris=12 * cells)
    n = int(j["n_tris"])
    want = assemble_mesh(np.asarray(j["keys"][:n]), np.asarray(j["tvals"][:n]), r)
    got = marching_tets_device(torch.from_numpy(grid), 0.0)
    assert got["n_cells"] == int(j["n_cells"]) and got["n_tris"] == n > 0
    np.testing.assert_array_equal(got["triangles"].numpy(), want.triangles)
    np.testing.assert_allclose(got["vertices"].numpy(), want.vertices, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", INTERIOR)
def test_matches_host_marching(name):
    """Against the host path (fp64 C++): equal vertex and triangle counts,
    triangle signatures within 1e-6 of the [-1,1] domain, signed volume to
    a relative 1e-6 (the same winding on every triangle)."""
    grid = GRIDS[name]()
    host = grid_to_mesh(grid, iso=0.0, to_unit=True)
    dev, stats = device_grid_to_mesh(torch.from_numpy(grid), iso=0.0, to_unit=True)
    assert stats["march_tris"] == len(dev.triangles) == len(host.triangles) > 0
    assert len(dev.vertices) == len(host.vertices)
    assert_same_triangles(dev, host, atol=1e-6)
    assert signed_volume(dev) == pytest.approx(signed_volume(host), rel=1e-6)


def test_border_orientation_follows_np_gradient():
    """Where a triangle's rounded centroid lies on the grid's border, the
    host marcher (native C++, bit-equal to the JAX package's) takes
    un-normalized differences (g[i+1] - g[i-1] inside, g[1] - g[0] at the
    border), while the device marcher, like JAX's, takes ``np.gradient``'s
    stencil; the two can wind such a triangle differently. On a random field
    that reaches the border the device path equals the JAX package's NumPy
    marcher (the executable spec), winding included, and the triangle sets
    of all three agree."""
    from ishapediting_tpu.geometry.marching import marching_tetrahedra

    grid = noisy_grid(20)
    spec = marching_tetrahedra(grid.astype(np.float64))
    dev, _ = device_grid_to_mesh(torch.from_numpy(grid), to_unit=False)
    host = grid_to_mesh(grid, iso=0.0, to_unit=False)
    assert_same_triangles(dev, spec, atol=1e-5)
    assert_same_triangles(host, spec, atol=1e-5)
    assert signed_volume(dev) == pytest.approx(signed_volume(spec), rel=1e-6)
    assert signed_volume(host) != pytest.approx(signed_volume(spec), rel=1e-3)


@pytest.mark.parametrize("name", ["blob24", "noisy20"])
def test_weld_shares_edges(name):
    """Every edge of the welded mesh belongs to at most 2 triangles."""
    out = marching_tets_device(torch.from_numpy(GRIDS[name]()))
    t = out["triangles"].numpy()
    edges = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert counts.max() <= 2 and len(np.unique(t)) == len(out["vertices"])


@pytest.mark.parametrize("value", [-1.0, 1.0])
def test_constant_grid_is_empty(value):
    mesh, stats = device_grid_to_mesh(torch.full((16, 16, 16), value))
    assert len(mesh.triangles) == 0 and len(mesh.vertices) == 0
    assert stats == {"march_cells": 0, "march_tris": 0}


def test_res_above_512_rejected():
    """The int32 edge key reaches INT32_MAX at 512^3; larger grids raise
    before any work (a meta tensor carries no data)."""
    with pytest.raises(ValueError, match="res <= 512"):
        marching_tets_device(torch.empty((513, 513, 513), device="meta"))


def test_engine_device_branch_matches_host_branch(monkeypatch):
    """``get_mesh`` on the device branch (taken by CUDA engines, forced here
    on the CPU) against the host branch on the same latent: same counts,
    triangle signatures within 1e-6, march walls under the JAX names."""
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.edit.engine import DragEngine

    engine = DragEngine(preset("tiny"), seed=0, device="cpu")
    latent = torch.randn((1,) + engine.config.latent_shape, generator=torch.Generator().manual_seed(7))
    host = engine.get_mesh(latent, smooth=0)
    assert engine.last_mesh_walls["impl"] == "host"
    monkeypatch.setattr(DragEngine, "_march_on_device", lambda self, res: True)
    dev = engine.get_mesh(latent, smooth=0)
    walls = engine.last_mesh_walls
    assert walls["impl"] == "device" and walls["march_tris"] == len(dev.triangles) > 0
    assert {"decode_device_s", "device_march_s", "march_cells", "n_verts", "total_s"} <= set(walls)
    assert_same_triangles(dev, host, atol=1e-6)
    assert engine._march_on_device(600)  # patched; the real rule is below
    monkeypatch.undo()
    assert not engine._march_on_device(256)  # a CPU engine marches on the host
