"""Port parity, the evaluation surfaces: ``cli.decode`` against the JAX
package's in every plane layout it takes, its reading of orbax decoders,
``cli.eval``'s pair, directory and local rows against JAX's, and the
solver sweep (``core/solver_eval.py``) against JAX's report from the same
x_T and weights, then through ``cli.eval --solver_sweep``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu.cli.decode import main as jdecode_main
from ishapediting_tpu.cli.eval import main as jeval_main
from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.core.solver_eval import solver_mesh_sweep as jsweep
from ishapediting_tpu.edit.engine import DragEngine as JDragEngine
from ishapediting_tpu.geometry.mesh import TriMesh as JTriMesh
from ishapediting_tpu_torch.cli.decode import main as decode_main
from ishapediting_tpu_torch.cli.edit import write_edit_log
from ishapediting_tpu_torch.cli.eval import main as eval_main
from ishapediting_tpu_torch.config import preset
from ishapediting_tpu_torch.core.solver_eval import solver_mesh_sweep
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.utils.threefry import normal, prng_key
from torch_parity_helpers import decoder_pair, unet_pair

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# cli.decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def decoder_pt(tmp_path_factory):
    _, tdec = decoder_pair(8, seed=6)
    path = tmp_path_factory.mktemp("dec") / "chairs_decoder.pt"
    torch.save(tdec.state_dict(), path)
    return str(path)


def planes_in_layout(layout, seed=0):
    nchw = (np.random.default_rng(seed).standard_normal((3, 8, 32, 32)) * 0.5).astype(np.float32)
    return {
        "flat_nchw": nchw.reshape(24, 32, 32),
        "nchw": nchw,
        "nhwc": nchw.transpose(0, 2, 3, 1).copy(),
    }[layout]


@pytest.mark.parametrize("layout", ["flat_nchw", "nchw", "nhwc"])
def test_cli_decode_matches_jax(tmp_path, decoder_pt, layout):
    """Same .pt decoder and planes: the same vertex and face counts, the
    same triangles up to winding, and vertices that differ only by the bf16
    decoder MLP's rounding (the packages accumulate its products in another
    order): within 2e-3 for 99.9% of them and a quarter voxel at most
    (see test_torch_compat.py::test_create_obj_matches_jax). The
    cross-section agrees to the pixel."""
    src = str(tmp_path / "planes.npy")
    np.save(src, planes_in_layout(layout))
    common = ["--input", src, "--model_path", decoder_pt, "--res", "24"]
    got = decode_main(common + ["--output", str(tmp_path / "port.obj"), "--device", "cpu",
                                "--cross_section", str(tmp_path / "port.png")])
    jdecode_main(common + ["--output", str(tmp_path / "jax.obj")])
    a, b = TriMesh.read(str(tmp_path / "port.obj")), JTriMesh.read(str(tmp_path / "jax.obj"))
    assert len(got) == 1 and len(got[0].vertices) == len(a.vertices)
    assert len(a.vertices) == len(b.vertices) > 0 and len(a.triangles) == len(b.triangles)
    np.testing.assert_array_equal(np.sort(a.triangles, axis=1), np.sort(b.triangles, axis=1))
    moved = np.abs(a.vertices - b.vertices).max(axis=1)
    assert np.quantile(moved, 0.999) < 2e-3 and moved.max() < 2 / 24 / 4
    assert os.path.getsize(tmp_path / "port.png") > 0


def test_cli_decode_many_inputs_smooth_and_random_init(tmp_path):
    """Several inputs into a directory, with smoothing, on a random decoder
    sized by the planes' channels."""
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"s{i}.npy"))
        np.save(paths[-1], planes_in_layout("flat_nchw", seed=i))
    out = tmp_path / "out"
    meshes = decode_main(["--input", *paths, "--output", str(out), "--random_init", "--res", "20",
                          "--smooth", "2", "--cross_section", "unused.png", "--device", "cpu"])
    assert len(meshes) == 2
    for i in range(2):
        assert (out / f"s{i}.obj").exists() and (out / f"s{i}_cross.png").exists()


def test_cli_decode_reads_orbax_and_defaults_to_cuda(tmp_path, decoder_pt, monkeypatch):
    """A decoder the JAX package saved with orbax (``--model_path`` its dir,
    or ``--model_dir`` holding ``decoder.orbax``) decodes to the mesh of the
    same weights' ``.pt``; an empty ``decoder.orbax`` names the missing
    manifest; bad planes are refused; without CUDA the default device
    raises."""
    from ishapediting_tpu.io.checkpoint import save_params as jsave_params

    src = str(tmp_path / "p.npy")
    np.save(src, planes_in_layout("nchw"))
    jdec, _ = decoder_pair(8, seed=6)  # decoder_pt's weights
    jsave_params(str(tmp_path / "decoder.orbax"), jdec)
    meshes = {}
    for name, flags in (("pt", ["--model_path", decoder_pt]),
                        ("orbax", ["--model_path", str(tmp_path / "decoder.orbax")]),
                        ("dir", ["--model_dir", str(tmp_path)])):
        out = tmp_path / f"{name}.obj"
        decode_main(["--input", src, "--output", str(out), "--res", "20", "--device", "cpu"] + flags)
        meshes[name] = out.read_bytes()
    assert meshes["orbax"] == meshes["pt"] and meshes["dir"] == meshes["pt"]
    empty = tmp_path / "empty" / "decoder.orbax"
    empty.mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="manifest.ocdbt"):
        decode_main(["--input", src, "--output", str(tmp_path / "o.obj"), "--model_path", str(empty),
                     "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="manifest.ocdbt"):
        decode_main(["--input", src, "--output", str(tmp_path / "o.obj"), "--model_dir", str(empty.parent),
                     "--device", "cpu"])
    with pytest.raises(SystemExit, match="expected 3 planes"):
        np.save(src, np.zeros((2, 8, 4, 4), np.float32))
        decode_main(["--input", src, "--output", str(tmp_path / "o.obj"), "--random_init", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(src, planes_in_layout("nchw"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_main(["--input", src, "--output", str(tmp_path / "o.obj"), "--model_path", decoder_pt])


# ---------------------------------------------------------------------------
# cli.eval, mesh pairs
# ---------------------------------------------------------------------------


def sphere_mesh(radius=0.6, center=(0.0, 0.0, 0.0), res=32):
    x = np.linspace(-1, 1, res)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    grid = radius - np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2 + (Z - center[2]) ** 2)
    return grid_to_mesh(grid, to_unit=True)


@pytest.fixture(scope="module")
def mesh_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    da, db = root / "a", root / "b"
    da.mkdir(), db.mkdir()
    sphere_mesh().write(str(da / "s0.obj"))
    sphere_mesh(0.5).write(str(da / "s1.ply"))
    sphere_mesh(center=(0.08, 0.0, 0.0)).write(str(db / "s0.obj"))
    sphere_mesh(0.55, center=(0.0, 0.05, 0.0)).write(str(db / "s1.ply"))
    log = root / "EditLog"
    write_edit_log(str(log), "01", np.array([[0.6, 0.0, 0.0]]), np.array([[0.7, 0.0, 0.0]]), 600.0, 0.2)
    write_edit_log(str(log), "02", np.array([[0.0, 0.6, 0.0], [0.0, 0.0, 0.5]]),
                   np.array([[0.0, 0.65, 0.0], [0.0, 0.0, 0.55]]), 1200.0, 0.4)
    return root


def _rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], float):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-9)
            else:
                assert g[k] == w[k]


@pytest.mark.parametrize("mode", ["pair", "dirs", "local_01", "local_02_l2"])
def test_cli_eval_rows_match_jax(mesh_dirs, mode, capsys):
    args = ["--point_num", "3000", "--seed", "1"]
    if mode == "pair":
        args += ["--mesh_a", str(mesh_dirs / "a" / "s0.obj"), "--mesh_b", str(mesh_dirs / "b" / "s0.obj"),
                 "--metrics", "chamfer", "hausdorff", "iou"]
    elif mode == "dirs":
        args += ["--dir_a", str(mesh_dirs / "a"), "--dir_b", str(mesh_dirs / "b"), "--metrics", "chamfer", "iou"]
    else:
        edit_id = mode.split("_")[1]
        args += ["--mesh_a", str(mesh_dirs / "a" / "s0.obj"), "--mesh_b", str(mesh_dirs / "b" / "s0.obj"),
                 "--metrics", "local", "chamfer", "--edit_log", str(mesh_dirs / "EditLog"), "--edit_id", edit_id,
                 "--local_r", "0.15"]
        if mode.endswith("l2"):
            args += ["--local_metric", "L2"]
    rows, summary = eval_main(args + ["--out", str(mesh_dirs / f"{mode}.json")])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    jrows, jsummary = jeval_main(args)
    _rows_match(rows, jrows)
    _rows_match([summary], [jsummary])
    assert lines == rows + [summary]
    assert json.load(open(mesh_dirs / f"{mode}.json")) == {"rows": rows, "summary": summary}
    assert len(rows) == (2 if mode == "dirs" else 1)


def test_cli_eval_refuses_bad_input(mesh_dirs, tmp_path):
    with pytest.raises(SystemExit, match="needs --edit_log"):
        eval_main(["--mesh_a", str(mesh_dirs / "a" / "s0.obj"), "--mesh_b", str(mesh_dirs / "b" / "s0.obj"),
                   "--metrics", "local"])
    (tmp_path / "c").mkdir()
    with pytest.raises(SystemExit, match="pair up"):
        eval_main(["--dir_a", str(mesh_dirs / "a"), "--dir_b", str(tmp_path / "c")])
    with pytest.raises(SystemExit, match="not in"):
        eval_main(["--mesh_a", str(mesh_dirs / "a" / "s0.obj"), "--mesh_b", str(mesh_dirs / "b" / "s0.obj"),
                   "--metrics", "local", "--edit_log", str(mesh_dirs / "EditLog"), "--edit_id", "07"])


# ---------------------------------------------------------------------------
# the solver sweep
# ---------------------------------------------------------------------------

SEED0 = 100


def jax_x_T(s, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(SEED0 + s), shape, jnp.float32))


@pytest.fixture(scope="module")
def sweep_pair():
    """The tiny preset with a 20-step base chain on the cosine schedule
    (the linear one scaled to 20 steps ends at beta 1), mesh res 32, the
    same weights in both packages. The random decoder's output bias is shifted
    by the median logit of the dense chain's first sample, so that the
    reference mesh has a surface (half of the grid inside)."""
    from ishapediting_tpu_torch.core.diffusion import ddim_sample_loop
    from ishapediting_tpu_torch.core.schedule import make_schedule

    cfg = preset("tiny")
    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(cfg.diffusion, base_steps=20,
                                                                 noise_schedule="cosine"))
    jcfg = jpreset("tiny")
    jcfg = dataclasses.replace(jcfg, diffusion=dataclasses.replace(jcfg.diffusion, base_steps=20,
                                                                   noise_schedule="cosine"))
    _, jparams, unet = unet_pair(dict(vars(cfg.unet)), seed=31)
    jdec, tdec = decoder_pair(cfg.plane_channels, seed=32)
    teng = DragEngine(cfg, unet=unet, decoder=tdec, device="cpu")
    dense = make_schedule(20, cfg.diffusion.noise_schedule, "")
    with torch.no_grad():
        x0 = ddim_sample_loop(dense, teng.model_fn(), torch.from_numpy(jax_x_T(0, (1,) + cfg.latent_shape)))
        shift = float(np.median(teng.decode_latent_grid(x0)))
        tdec[5].bias -= shift
    jdec = dict(jdec, dense3=dict(jdec["dense3"], b=jdec["dense3"]["b"] - shift))
    jeng = JDragEngine(jcfg, unet_params=jparams, decoder_params=jdec)
    return jeng, teng


def test_sweep_draws_are_jax_draws():
    """The sweep's own x_T are JAX's for the same seeds, to 2e-5 (XLA
    evaluates erfinv by a fp32 polynomial, the port in fp64)."""
    shape = (1,) + preset("tiny").latent_shape
    for s in range(2):
        np.testing.assert_allclose(normal(prng_key(SEED0 + s), shape), jax_x_T(s, shape), rtol=0, atol=2e-5)


def _recording(engine, latents):
    """Record every latent the sweep hands to ``engine.get_mesh``."""
    get_mesh = engine.get_mesh

    def record(latent, *args, **kw):
        latents.append(np.asarray(latent, np.float32).copy())
        return get_mesh(latent, *args, **kw)

    engine.get_mesh = record


def test_solver_sweep_matches_jax(sweep_pair):
    """With JAX's x_T injected, the dense reference and every solver, the
    ancestral chain with its step noise from JAX's ``run_key`` stream
    included, reach JAX's latents to 1e-4, and their rows match JAX's
    report: cd_mean to 1e-4 and iou_mean to 1e-2. The meshes themselves
    differ by the bf16 decoder MLP's rounding (about 1e-4 here), which
    moves IoU's near-surface probes (sigma 0.01) across a surface and lets
    the area-weighted sampler pick a neighbouring triangle for some points;
    at 20,000 points that is within 5e-3 of IoU (at 2,000, 2e-2)."""
    jeng, teng = sweep_pair
    kw = dict(n_seeds=1, seed0=SEED0, budgets=(10, 5), max_attempts=1, point_num=20_000)
    jlat, tlat = [], []
    _recording(jeng, jlat)
    _recording(teng, tlat)
    try:
        want = jsweep(jeng, **kw)
        got = solver_mesh_sweep(teng, x_Ts=[jax_x_T(0, (1,) + teng.config.latent_shape)], **kw)
    finally:
        del jeng.get_mesh, teng.get_mesh
    assert got.keys() == want.keys()
    assert got["ref"] == want["ref"] == "ddim20-dense"
    assert got["seeds"] == want["seeds"] == 1
    names = ["ref"] + [k for k in got if k.startswith(("ddpm", "ddim", "dpm"))]
    assert len(tlat) == len(jlat) == len(names) == 6
    for name, t, j in zip(names, tlat, jlat):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4, err_msg=name)
    for name in ("ddpm20", "ddim10", "dpm10", "ddim5", "dpm5"):
        assert got[name]["empty"] == want[name]["empty"] == 0
        np.testing.assert_allclose(got[name]["cd_mean"], want[name]["cd_mean"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[name]["iou_mean"], want[name]["iou_mean"], rtol=0, atol=1e-2)


def test_solver_sweep_skips_budgets_at_or_above_base(sweep_pair):
    _, teng = sweep_pair
    got = solver_mesh_sweep(teng, n_seeds=1, seed0=SEED0, budgets=(20, 30, 3), max_attempts=1, point_num=500)
    assert got["skipped_budgets_at_or_above_base"] == [20, 30]
    assert "dpm3" in got and "ddim3" not in got  # 20 % 3: no integer stride


def test_cli_solver_sweep_writes_report(tmp_path):
    out = tmp_path / "sweep.json"
    report = eval_main(["--solver_sweep", "--random_init", "--preset", "tiny", "--budgets", "10", "5",
                        "--sweep_seeds", "1", "--max_attempts", "2", "--point_num", "1000", "--out", str(out),
                        "--device", "cpu"])
    assert report["ref"] == "ddim100-dense"
    for name in ("ddpm100", "ddim10", "dpm10", "ddim5", "dpm5"):
        assert name in report
    assert json.load(open(out)) == report


def test_cli_solver_sweep_needs_a_model_and_defaults_to_cuda(monkeypatch):
    with pytest.raises(SystemExit, match="needs --model_dir or --random_init"):
        eval_main(["--solver_sweep", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_main(["--solver_sweep", "--random_init", "--preset", "tiny"])
