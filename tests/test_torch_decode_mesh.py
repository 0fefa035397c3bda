"""Port parity, decoder and mesh: ``decode_grid`` against JAX's (fp32, 1e-4)
and against the port's own ``decode_points`` on the same lattice (5e-4, as
JAX pins for its pair), a bf16 sanity bound, ``decode_points`` against JAX's,
and ``grid_to_mesh`` on a JAX-decoded grid against JAX's mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu.geometry.marching import grid_to_mesh as j_grid_to_mesh
from ishapediting_tpu.ops import triplane as jtri
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.ops import triplane as ttri
from torch_parity_helpers import decoder_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    jdec, tdec = decoder_pair(in_channels=8, seed=3)
    planes = np.random.default_rng(4).normal(size=(3, 16, 16, 8)).astype(np.float32)
    return jdec, tdec, planes


def _lattice(res):
    x = np.linspace(-1, 1, res).astype(np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return np.stack([X, Y, Z], axis=-1).reshape(-1, 3)


def test_decode_grid_matches_jax_fp32(pair):
    jdec, tdec, planes = pair
    want = jtri.decode_grid(jdec, jnp.asarray(planes), res=32, chunk=8, compute_dtype=jnp.float32)
    got = ttri.decode_grid(tdec, torch.from_numpy(planes), res=32, chunk=8, compute_dtype=torch.float32)
    assert got.shape == (32, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_decode_grid_matches_own_decode_points(pair):
    _, tdec, planes = pair
    res = 12
    grid = ttri.decode_grid(tdec, torch.from_numpy(planes), res=res, chunk=5, compute_dtype=torch.float32)
    with torch.no_grad():
        pts = ttri.decode_points(tdec, torch.from_numpy(planes), torch.from_numpy(_lattice(res)))
    np.testing.assert_allclose(grid.numpy(), pts.numpy().reshape(res, res, res), atol=5e-4)


def test_decode_grid_bf16_sanity(pair):
    """bf16 MLP matmuls against fp32: within 5% of the logit scale (the
    JAX package's bound for the same pair), written into an fp16 grid."""
    _, tdec, planes = pair
    p = torch.from_numpy(planes)
    g32 = ttri.decode_grid(tdec, p, res=16, chunk=8, compute_dtype=torch.float32).numpy()
    g16 = ttri.decode_grid(tdec, p, res=16, chunk=8, out_dtype=torch.float16)
    assert g16.dtype == torch.float16
    assert np.abs(g32 - g16.float().numpy()).max() < 0.05 * max(1.0, np.abs(g32).max())


def test_decode_points_matches_jax(pair):
    jdec, tdec, planes = pair
    coords = np.random.default_rng(5).uniform(-1, 1, (257, 3)).astype(np.float32)
    want = jtri.decode_points(jdec, jnp.asarray(planes), jnp.asarray(coords))
    with torch.no_grad():
        got = ttri.decode_points(tdec, torch.from_numpy(planes), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_grid_to_mesh_matches_jax(pair, tmp_path):
    jdec, _, planes = pair
    grid = np.asarray(jtri.decode_grid(jdec, jnp.asarray(planes), res=24, compute_dtype=jnp.float32))
    want = j_grid_to_mesh(grid, iso=0.0, to_unit=True)
    got = grid_to_mesh(grid, iso=0.0, to_unit=True)
    assert len(got.triangles) > 0
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_allclose(got.vertices, want.vertices, atol=1e-12)
    smoothed = got.filter_smooth_simple(3)
    np.testing.assert_allclose(smoothed.vertices, want.filter_smooth_simple(3).vertices, atol=1e-12)
    path = str(tmp_path / "m.obj")
    smoothed.write(path)
    back = TriMesh.read(path)
    np.testing.assert_array_equal(back.triangles, smoothed.triangles)
    np.testing.assert_allclose(back.vertices, smoothed.vertices, rtol=1e-7, atol=1e-8)
