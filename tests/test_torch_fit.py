"""Port parity, the real-shape fit and ``cli.edit`` on ``preset("tiny")``:
``sample_training_points`` equal to JAX's for the same seed (NumPy draws,
native occupancy), ``bce_with_logits``, the mesh helpers, one guidance
gradient against ``jax.grad``, ``fit_guided`` end to end with JAX's draws
injected, ``DragEngine.fit_real_shape`` (the ``tri_feat.npy`` /
``mesh_recon.obj`` contract and the cached reload), and ``cli.edit`` (its
outputs, the EditLog byte-equal to JAX's ``write_edit_log``).

Tolerances: points and labels exact; BCE rel 1e-6; the guidance gradient
1e-4 of its largest magnitude; the fitted latent atol 1e-4 (three guided
steps at scale 1).

The direct fit (``fit_direct``, ``DragEngine.fit_real_shape_direct``):
``tv_reg``/``l2_reg`` and their gradients rel 1e-5; the fitted latent atol
2e-5 against ``optax.adam``'s after 8 Adam steps at lr 1e-3 with JAX's
draws injected (the two Adams round differently: an update is lr times
m/(sqrt(v)+eps), so a last-bit difference in a gradient moves an update by
about 1e-3 of lr per step).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu.cli import edit as jcli
from ishapediting_tpu.config import FitConfig as JFitConfig
from ishapediting_tpu.core import diffusion as jdiff
from ishapediting_tpu.core.schedule import make_schedule as j_make_schedule
from ishapediting_tpu.edit import fit as jfit
from ishapediting_tpu.geometry import occupancy as jocc
from ishapediting_tpu.geometry.mesh import TriMesh as JTriMesh
from ishapediting_tpu.models.unet import unet_apply
from ishapediting_tpu.edit.engine import DragEngine as JDragEngine
from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.ops.triplane import decode_points as j_decode_points
from ishapediting_tpu.ops.triplane import l2_reg as j_l2_reg
from ishapediting_tpu.ops.triplane import tv_reg as j_tv_reg
from ishapediting_tpu_torch.cli import edit as tcli
from ishapediting_tpu_torch.config import FitConfig, preset
from ishapediting_tpu_torch.core import diffusion as tdiff
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.edit import fit as tfit
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.geometry.occupancy import points_occupancy
from ishapediting_tpu_torch.ops.triplane import decode_points, l2_reg, tv_reg
from torch_parity_helpers import decoder_pair, to_torch, unet_pair

torch.set_num_threads(2)

CFG = preset("tiny")


def sphere_mesh(res=24, r=0.5, center=(0.1, 0.0, -0.05)):
    x = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    c = np.asarray(center, np.float32)
    grid = r - np.sqrt((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2)
    return grid_to_mesh(grid.astype(np.float32), iso=0.0, to_unit=True)


def test_sample_training_points_matches_jax():
    mesh = sphere_mesh()
    jmesh = JTriMesh(mesh.vertices.copy(), mesh.triangles.copy())
    kw = dict(points_size=3000, points_uniform_ratio=0.5, surface_jitter=0.01)
    got = tfit.sample_training_points(mesh, FitConfig(**kw), seed=4)
    want = jfit.sample_training_points(jmesh, JFitConfig(**kw), seed=4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert 0.05 < got[1].mean() < 0.6  # both labels occur


def test_mesh_helpers_match_jax():
    rng = np.random.default_rng(6)
    mesh = sphere_mesh()
    mesh.vertices = mesh.vertices * 1.7 + 0.4  # out of [-1, 1]: normalized
    jmesh = JTriMesh(mesh.vertices.copy(), mesh.triangles.copy())
    np.testing.assert_array_equal(mesh.copy().normalize_unit_cube().vertices,
                                  jmesh.copy().normalize_unit_cube().vertices)
    inside = TriMesh(mesh.vertices * 0.1, mesh.triangles)
    np.testing.assert_array_equal(inside.copy().normalize_unit_cube().vertices, inside.vertices)
    np.testing.assert_array_equal(mesh.triangle_areas(), jmesh.triangle_areas())
    np.testing.assert_array_equal(mesh.sample_points_uniformly(500, seed=2),
                                  jmesh.sample_points_uniformly(500, seed=2))
    pts = rng.uniform(-1.5, 1.5, (2000, 3))
    np.testing.assert_array_equal(points_occupancy(mesh, pts), jocc.points_occupancy(jmesh, pts))


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(500, 1)) * 30).astype(np.float32)
    labels = (rng.random((500, 1)) > 0.5).astype(np.float32)
    got = tfit.bce_with_logits(to_torch(logits), to_torch(labels))
    want = jfit.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    ref = torch.nn.functional.binary_cross_entropy_with_logits(to_torch(logits), to_torch(labels))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg, jparams, unet = unet_pair(dict(vars(CFG.unet)), seed=41)
    jdec, tdec = decoder_pair(CFG.plane_channels, seed=42)
    jmf = lambda x, t: unet_apply(jcfg, jparams, x, t)  # noqa: E731
    return jmf, jdec, unet, tdec


def _pool(n=2000, seed=8):
    mesh = sphere_mesh()
    return tfit.sample_training_points(mesh, FitConfig(points_size=n), seed=seed)


def test_guidance_gradient_matches_jax(models):
    """d/dx of -BCE(decode(planes(pred_x0(x))), labels) through the UNet and
    the decoder, one step, the same noise and point batch."""
    jmf, jdec, unet, tdec = models
    points, occ = _pool()
    x = np.random.default_rng(9).normal(size=(1,) + CFG.latent_shape).astype(np.float32)
    hr = np.linspace(0.5, 1.5, CFG.latent_shape[-1]).astype(np.float32)
    mid = np.linspace(-0.2, 0.2, CFG.latent_shape[-1]).astype(np.float32)
    idx = np.random.default_rng(10).integers(0, len(points), 500)
    coords, labels = points[idx], occ[idx][:, None]
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    js, ts = j_make_schedule(100, "linear", "10"), make_schedule(100, "linear", "10")

    def jloss(im):
        out = jdiff.p_sample_guidance(js, jmf, im, jnp.full((1,), 6, jnp.int32), key)
        planes = jfit.latents_to_planes(out["pred_xstart"], jnp.asarray(hr), jnp.asarray(mid))
        return -jfit.bce_with_logits(j_decode_points(jdec, planes[0], jnp.asarray(coords)),
                                     jnp.asarray(labels))

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(x))
    im = to_torch(x).requires_grad_(True)
    out = tdiff.p_sample_guidance(ts, lambda a, b: unet(a, b), im, torch.full((1,), 6),
                                  noise=to_torch(noise))
    planes = tfit.latents_to_planes(out["pred_xstart"], to_torch(hr), to_torch(mid))
    loss = -tfit.bce_with_logits(decode_points(tdec, planes[0], to_torch(coords)), to_torch(labels))
    (grad,) = torch.autograd.grad(loss, im)
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-5)
    jg = np.asarray(jgrad)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(grad.numpy(), jg, atol=1e-4 * np.abs(jg).max())


def test_fit_guided_matches_jax(models):
    """Three guided steps from JAX's x_T, step noises and point batches:
    fitted latent to 1e-4 at guidance scale 1, where the guidance moves the
    latent by over 1e-2. (At the product's scale 600 random weights push
    many elements of pred_x0 onto the clip at +-1, where the gradient jumps,
    and the two implementations' last-bit differences decide which side an
    element lands on: the per-step gradient is held to JAX by
    ``test_guidance_gradient_matches_jax`` instead.)"""
    jmf, jdec, unet, tdec = models
    points, occ = _pool()
    js, ts = j_make_schedule(100, "linear", "3"), make_schedule(100, "linear", "3")
    shape = CFG.latent_shape
    hr = np.ones(shape[-1], np.float32)
    mid = np.zeros(shape[-1], np.float32)
    rng = jax.random.PRNGKey(11)
    bp = 400
    want = jfit.fit_guided(js, jmf, jdec, jnp.asarray(points), jnp.asarray(occ), jnp.asarray(hr),
                           jnp.asarray(mid), rng, latent_shape=shape, batch_points=bp, scale=1.0)
    loop_rng, init_rng = jax.random.split(rng)
    x_T = np.array(jax.random.normal(init_rng, (1,) + shape, jnp.float32))
    noises, batches = [], []
    for t in range(js.num_timesteps - 1, -1, -1):
        r_noise, r_batch = jax.random.split(jax.random.fold_in(loop_rng, t))
        batches.append(np.array(jax.random.randint(r_batch, (1, bp), 0, len(points))))
        noises.append(np.array(jax.random.normal(r_noise, (1,) + shape, jnp.float32)))
    def fit(scale):
        return tfit.fit_guided(ts, lambda a, b: unet(a, b), tdec, to_torch(points), to_torch(occ),
                               to_torch(hr), to_torch(mid), latent_shape=shape, batch_points=bp,
                               scale=scale, x_T=to_torch(x_T), noises=noises, batch_indices=batches)

    got = fit(1.0)
    assert got.shape == (1,) + shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float((got - fit(0.0)).abs().max()) > 1e-2


def test_fit_real_shape_contract(tmp_path):
    """Fast fit (3 steps) of a sphere: ``tri_feat.npy`` [1, C, H, W] and
    ``mesh_recon.obj`` written, the inversion state set; reloading the cached
    fit through ``tri_feat_path`` gives the same inversion."""
    engine = DragEngine(CFG, seed=1, device="cpu")
    mesh_path = str(tmp_path / "shape.obj")
    sphere_mesh().write(mesh_path)
    engine.fit_real_shape(mesh_path=mesh_path, path=str(tmp_path), seed=2, fit_steps=3)
    h, w, c = CFG.latent_shape
    tri = np.load(tmp_path / "tri_feat.npy")
    assert tri.shape == (1, c, h, w) and np.isfinite(tri).all()
    assert os.path.getsize(tmp_path / "mesh_recon.obj") > 0
    assert len(TriMesh.read(str(tmp_path / "mesh_recon.obj")).vertices) == len(engine.mesh0.vertices) > 0
    walls = engine.last_phase_walls
    assert walls["path"] == "fit" and walls["fit_steps"] == 3
    assert engine.variances.shape == (CFG.edit.w_time, 1, h, w, c)
    w_fit = engine.w.clone()
    feats = engine.feature_guidance.clone()
    engine.clear_params()
    engine.fit_real_shape(tri_feat_path=str(tmp_path / "tri_feat.npy"))
    torch.testing.assert_close(engine.w, w_fit, atol=0, rtol=0)
    torch.testing.assert_close(engine.feature_guidance, feats, atol=0, rtol=0)
    with pytest.raises(ValueError, match="fit_steps must be >= 2"):
        engine.fit_real_shape(mesh_path=mesh_path, path=str(tmp_path / "b"), fit_steps=1)


def test_edit_log_format_matches_jax(tmp_path):
    src = np.array([[0.1, 0.2, 0.3], [-0.5, 0.25, 0.0]], np.float32)
    tgt = src + np.float32(0.125)
    for mod, name in ((tcli, "port"), (jcli, "jax")):
        mod.write_edit_log(str(tmp_path / name), "01", src, tgt, 1200.0, 0.4)
        mod.write_edit_log(str(tmp_path / name), "02", src[:1], tgt[:1], 600.0, 0.2)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    got, want = tcli.parse_edit_log(str(tmp_path / "port")), jcli.parse_edit_log(str(tmp_path / "jax"))
    assert got.keys() == want.keys() == {"01", "02"}
    for k in got:
        for f in ("sources", "targets"):
            np.testing.assert_array_equal(got[k][f], want[k][f])
        assert (got[k]["scale"], got[k]["lam"]) == (want[k]["scale"], want[k]["lam"])


def test_cli_edit_generated_shape(tmp_path):
    out = tmp_path / "out"
    tcli.main(["--random_init", "--preset", "tiny", "--device", "cpu", "--latent_seed", "3",
               "--source", "0.2", "0", "0", "--target", "0.4", "0", "0", "--scale", "20",
               "--lam", "0.2", "--edit_steps", "3", "--out", str(out)])
    for f in ("original.obj", "edit00.obj"):
        assert os.path.getsize(out / f) > 0
    jcli.write_edit_log(str(tmp_path / "want"), "00", np.array([[0.2, 0, 0]], np.float32),
                        np.array([[0.4, 0, 0]], np.float32), 20.0, 0.2)
    assert (out / "EditLog").read_bytes() == (tmp_path / "want").read_bytes()


def test_cli_edit_log_and_latent_npy(tmp_path):
    """Edits from an EditLog (one picked by ``--edit_id``) on an x_T given
    as an NCHW .npy."""
    log = str(tmp_path / "EditLog")
    tcli.write_edit_log(log, "07", [[0.1, 0, 0]], [[0.3, 0, 0]], 10.0, 0.1)
    tcli.write_edit_log(log, "08", [[0, 0.1, 0]], [[0, 0.3, 0]], 10.0, 0.1)
    h, w, c = CFG.latent_shape
    np.save(tmp_path / "x.npy", np.random.default_rng(1).normal(size=(1, c, h, w)).astype(np.float32))
    out = tmp_path / "out"
    engine = tcli.main(["--random_init", "--preset", "tiny", "--device", "cpu", "--latent_npy",
                        str(tmp_path / "x.npy"), "--edit_log", log, "--edit_id", "08",
                        "--out", str(out)])
    assert os.path.getsize(out / "edit08.obj") > 0 and not (out / "edit07.obj").exists()
    np.testing.assert_array_equal(engine.latent_code.transpose(0, 3, 1, 2), np.load(tmp_path / "x.npy"))


def test_cli_edit_real_mesh_and_cache(tmp_path, capsys):
    mesh_path = str(tmp_path / "m" / "shape.obj")
    os.makedirs(os.path.dirname(mesh_path))
    sphere_mesh().write(mesh_path)
    argv = ["--random_init", "--preset", "tiny", "--device", "cpu", "--mesh", mesh_path,
            "--fit_steps", "3", "--source", "0.5", "0", "0", "--target", "0.6", "0", "0",
            "--edit_steps", "3", "--out", str(tmp_path / "o")]
    tcli.main(argv)
    assert "fast fitting: 3 of 10 guided steps" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "m" / "tri_feat.npy")
    assert os.path.exists(tmp_path / "m" / "mesh_recon.obj")
    tcli.main(argv)
    assert "using cached fit" in capsys.readouterr().out
    assert os.path.getsize(tmp_path / "o" / "edit00.obj") > 0


def test_cli_edit_render(tmp_path):
    """``--render`` writes before/after PNGs (the JAX CLI's names)."""
    from PIL import Image

    tcli.main(["--random_init", "--preset", "tiny", "--device", "cpu", "--latent_seed", "3", "--source",
               "0.2", "0", "0", "--target", "0.4", "0", "0", "--edit_steps", "2", "--render",
               "--out", str(tmp_path)])
    for name in ("original.png", "edit00.png"):
        img = np.asarray(Image.open(tmp_path / name))
        assert img.shape == (512, 512, 3) and (img != 255).any(), name


def test_cli_edit_refusals(tmp_path):
    base = ["--random_init", "--preset", "tiny", "--device", "cpu", "--out", str(tmp_path)]
    with pytest.raises(SystemExit, match="source/--target"):
        tcli.main(base + ["--render", "--source", "0", "0", "0"])
    with pytest.raises(SystemExit, match="source/--target"):
        tcli.main(base)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--random_init", "--preset", "tiny", "--source", "0", "0", "0",
                       "--target", "0", "0", "0", "--out", str(tmp_path)])


def test_engine_entry_points_take_tensors_and_arrays():
    """``update_latent_params`` and ``latent_inversion`` take the latent as
    a NumPy array or a tensor (``fit_real_shape`` hands the inversion the
    fitted tensor where it lies): the same record either way."""
    engine = DragEngine(CFG, seed=1, device="cpu")
    x = np.random.default_rng(2).normal(size=(1,) + CFG.latent_shape).astype(np.float32)
    a = engine.update_latent_params(latent=x, seed=0)
    b = engine.update_latent_params(latent=torch.from_numpy(x), seed=0)
    np.testing.assert_array_equal(a, b)
    engine.latent_inversion(a)
    w = engine.w.clone()
    engine.latent_inversion(torch.from_numpy(a))
    torch.testing.assert_close(engine.w, w, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the direct fit
# ---------------------------------------------------------------------------


def test_tv_and_l2_reg_match_jax():
    planes = np.random.default_rng(12).normal(size=(3, 8, 9, 4)).astype(np.float32)
    for tfn, jfn in ((tv_reg, j_tv_reg), (l2_reg, j_l2_reg)):
        jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(planes))
        p = to_torch(planes).requires_grad_(True)
        val = tfn(p)
        (grad,) = torch.autograd.grad(val, p)
        assert float(val.detach()) == pytest.approx(float(jval), rel=1e-5)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)


def jax_direct_draws(rng, cfg, p_total, shape):
    """JAX ``fit_direct``'s draws from ``rng``: the init normals, then per
    step ``split(key, 3)`` into the point indices, the uniform coordinates
    and the jitter normals."""
    rng, init_rng = jax.random.split(rng)
    init = np.asarray(jax.random.normal(init_rng, (1,) + shape, jnp.float32))
    draws = []
    for _ in range(cfg.opt_epochs * max(1, p_total // cfg.batch_points)):
        rng, key = jax.random.split(rng)
        k_batch, k_rand, k_off = jax.random.split(key, 3)
        bshape = (cfg.batch_points, 3)
        draws.append((np.asarray(jax.random.randint(k_batch, (cfg.batch_points,), 0, p_total)),
                      np.asarray(jax.random.uniform(k_rand, bshape, jnp.float32, -1.0, 1.0)),
                      np.asarray(jax.random.normal(k_off, bshape))))
    return init, draws


@pytest.mark.parametrize("with_stats", [False, True])
def test_fit_direct_matches_jax(models, with_stats):
    """Eight Adam steps (2 epochs of 4 batches) on the same points, from
    JAX's draws; with the category's means/stds and without them."""
    _, jdec, _, tdec = models
    points, occ = _pool(n=2000)
    shape = CFG.latent_shape
    kw = dict(points_size=2000, batch_points=500, opt_epochs=2)
    jcfg, tcfg = JFitConfig(**kw), FitConfig(**kw)
    rng = np.random.default_rng(13)
    hr = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    mid = rng.uniform(-0.2, 0.2, shape[-1]).astype(np.float32)
    means = rng.normal(size=shape[-1]).astype(np.float32) * 0.1 if with_stats else None
    stds = rng.uniform(0.05, 0.2, shape[-1]).astype(np.float32) if with_stats else None
    key = jax.random.PRNGKey(14)
    want = jfit.fit_direct(jdec, jnp.asarray(points), jnp.asarray(occ), jnp.asarray(hr), jnp.asarray(mid),
                           means, stds, key, jcfg, latent_shape=shape)
    init, draws = jax_direct_draws(key, jcfg, len(points), shape)
    losses = []
    got = tfit.fit_direct(tdec, to_torch(points), to_torch(occ), to_torch(hr), to_torch(mid), means, stds,
                          None, tcfg, latent_shape=shape, init_noise=to_torch(init), draws=draws,
                          losses=losses)
    assert got.shape == (1,) + shape and len(losses) == 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    start = tfit.fit_direct(tdec, to_torch(points), to_torch(occ), to_torch(hr), to_torch(mid), means, stds,
                            None, dataclasses.replace(tcfg, opt_epochs=0), latent_shape=shape,
                            init_noise=to_torch(init))
    assert float((got - start).abs().max()) > 1e-3  # the fit moved the planes


def test_fit_real_shape_direct_contract(tmp_path):
    """``tri_feat_opt.npy`` (NCHW) and ``mesh_opt.obj`` written, the latent
    returned equal to the saved one, the per-step losses recorded; the same
    seed gives the same fit (to 1e-7); the JAX engine with the same weights and
    draws gives the same latent."""
    _, jparams, unet = unet_pair(dict(vars(CFG.unet)), seed=43)
    jdec, tdec = decoder_pair(CFG.plane_channels, seed=44)
    engine = DragEngine(CFG, unet=unet, decoder=tdec, device="cpu")
    mesh = sphere_mesh()
    mesh_path = str(tmp_path / "shape.obj")
    mesh.write(mesh_path)
    lat = engine.fit_real_shape_direct(mesh_path=mesh_path, path=str(tmp_path / "a"), seed=3)
    h, w, c = CFG.latent_shape
    tri = np.load(tmp_path / "a" / "tri_feat_opt.npy")
    assert tri.shape == (1, c, h, w)
    np.testing.assert_array_equal(tri.transpose(0, 2, 3, 1), lat)
    assert os.path.exists(tmp_path / "a" / "mesh_opt.obj")
    steps = CFG.fit.opt_epochs * (CFG.fit.points_size // CFG.fit.batch_points)
    assert engine.last_fit_losses.shape == (steps,) and np.isfinite(engine.last_fit_losses).all()
    walls = engine.last_phase_walls
    assert walls["path"] == "fit_direct" and walls["opt_steps"] == steps
    again = engine.fit_real_shape_direct(mesh=mesh, path=str(tmp_path / "b"), seed=3)
    np.testing.assert_allclose(again, lat, atol=1e-7)  # the CPU's scatter-add order varies
    with pytest.raises(ValueError, match="need mesh"):
        engine.fit_real_shape_direct()

    jeng = JDragEngine(jpreset("tiny"), unet_params=jparams, decoder_params=jdec)
    want = np.asarray(jeng.fit_real_shape_direct(mesh=JTriMesh(mesh.vertices.copy(), mesh.triangles.copy()),
                                                 path=str(tmp_path / "j"), seed=5))
    init, draws = jax_direct_draws(jax.random.PRNGKey(5), jeng.config.fit, CFG.fit.points_size,
                                   CFG.latent_shape)
    got = engine.fit_real_shape_direct(mesh=mesh, path=str(tmp_path / "t"), seed=5,
                                       init_noise=to_torch(init), draws=draws)
    np.testing.assert_allclose(got, want, atol=2e-5)
