"""Port parity, the generation path end to end: the tiny ``DragEngine``
against the JAX engine from the same x_T, weights and step noise; the
``cli.generate`` output contract; the device default (no silent CPU
fallback); and import hygiene (the port never loads JAX or the JAX package).
"""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.edit.engine import DragEngine as JDragEngine
from ishapediting_tpu_torch.config import preset
from ishapediting_tpu_torch.edit.engine import DragEngine
from torch_parity_helpers import decoder_pair, jax_step_noises, unet_pair

torch.set_num_threads(2)

PKG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ishapediting_tpu_torch")


def chamfer(a, b):
    return cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean()


def test_tiny_engine_matches_jax_engine():
    """Same x_T, weights and per-step noise: the latents and guidance
    features agree to 1e-4; the meshes (32^3 grid, bf16 decoder MLP, fp16
    grid, 10 smoothing steps) have the same vertex count and a symmetric
    Chamfer distance below 1e-3 (a voxel is 2/32 = 0.0625)."""
    cfg = preset("tiny")
    jcfg, jparams, unet = unet_pair(dict(vars(cfg.unet)), seed=21)
    jdec, tdec = decoder_pair(cfg.plane_channels, seed=22)
    x_T = np.random.default_rng(23).normal(size=(1,) + cfg.latent_shape).astype(np.float32)

    jeng = JDragEngine(jpreset("tiny"), unet_params=jparams, decoder_params=jdec)
    want = jeng.update_latent_params(latent=x_T, seed=0)
    noises = jax_step_noises(jax.random.PRNGKey(1), x_T.shape, jeng.sched.num_timesteps)
    teng = DragEngine(cfg, unet=unet, decoder=tdec, device="cpu")
    got = teng.update_latent_params(latent=x_T, seed=0, noises=noises)

    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(teng.w.numpy(), np.asarray(jeng.w), atol=1e-4)
    np.testing.assert_allclose(
        teng.feature_guidance.numpy(), np.asarray(jeng.feature_guidance), atol=1e-4
    )
    assert len(teng.mesh.vertices) > 0
    assert len(teng.mesh.vertices) == len(jeng.mesh.vertices)
    assert chamfer(teng.mesh.vertices, jeng.mesh.vertices) < 1e-3

    teng.reset_params()
    assert teng.mesh is not teng.mesh0
    np.testing.assert_array_equal(teng.mesh.vertices, teng.mesh0.vertices)
    teng.clear_params()
    assert teng.mesh is None and teng.feature_guidance is None


def test_engine_random_init_seeded():
    """Random weights come from the seed; zero modules stay zero."""
    a = DragEngine(preset("tiny"), seed=3, device="cpu")
    b = DragEngine(preset("tiny"), seed=3, device="cpu")
    for (k, va), vb in zip(a.unet.state_dict().items(), b.unet.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not a.unet.state_dict()["out.2.weight"].any()
    lat = a.update_latent_params(seed=1)
    assert lat.shape == (1,) + preset("tiny").latent_shape and np.isfinite(lat).all()
    assert a.feature_guidance.shape[0] == preset("tiny").edit.w_time


def test_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DragEngine(preset("tiny"))
    from ishapediting_tpu_torch.cli.generate import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--random_init", "--preset", "tiny", "--num_samples", "1"])


@pytest.mark.parametrize("sampler", ["--use_ddim", "--use_dpm"])
def test_cli_generate_contract(tmp_path, sampler):
    from ishapediting_tpu_torch.cli.generate import main

    out = str(tmp_path / "gen")
    main([
        "--random_init", "--preset", "tiny", "--device", "cpu", sampler,
        "--num_steps", "5", "--num_samples", "2", "--batch_size", "2",
        "--shape_resolution", "16", "--save_dir", out,
    ])
    for i in range(2):
        tri = np.load(f"{out}/triplanes/{i}.npy")
        assert tri.shape == (6, 16, 16) and tri.dtype == np.float32 and np.isfinite(tri).all()
        assert os.path.getsize(f"{out}/objects/{i}.obj") > 0


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG_DIR):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), os.path.dirname(PKG_DIR))
                mods.append(rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
    return mods


def test_port_imports_neither_jax_nor_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ishapediting_tpu' or m.startswith('ishapediting_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('ishapediting_tpu_torch')]))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=os.path.dirname(PKG_DIR),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_port_sources_have_no_jax_imports():
    paths = [os.path.join(os.path.dirname(PKG_DIR), "chip_smoke.py")]
    for root, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for f in paths:
        for node in ast.walk(ast.parse(open(f).read())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "ishapediting_tpu"), (f, n)
