"""Port parity, the samplers of the serving surfaces and morphing on
``preset("tiny")``: ``ddim_reverse_sample_loop``, ``sample_partial``,
``p_sample_loop_snapshots``, ``slerp`` (generic, parallel, antiparallel and
zero endpoints), ``morph_latents``, ``DragEngine.sample_latent`` and
``DragEngine.morph`` against the JAX package with the same weights and, for
stochastic steps, JAX's own draws injected; then ``cli.morph`` and
``cli.generate --save_intermediate / --save_npz / --sharded_decode``.

Tolerances: latents atol 1e-4 (fp32 UNet, 2 threads); morphed frames atol
1e-3 (an encode of 9 steps and a decode of 10 through the same UNet, where
the two implementations' fp32 rounding grows to about 2e-4 on a few
elements); ``slerp`` atol 1e-6; snapshot tensors written by the CLI equal
(0) to the loop's own.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu.cli import generate as jgen
from ishapediting_tpu.cli import morph as jcli_morph
from ishapediting_tpu.config import preset as jpreset
from ishapediting_tpu.core import diffusion as jdiff
from ishapediting_tpu.edit import features as jfeat
from ishapediting_tpu.edit import morph as jmorph
from ishapediting_tpu.edit.engine import DragEngine as JDragEngine
from ishapediting_tpu_torch.cli import generate as tgen
from ishapediting_tpu_torch.cli import morph as tcli_morph
from ishapediting_tpu_torch.config import preset
from ishapediting_tpu_torch.core import diffusion as tdiff
from ishapediting_tpu_torch.edit import features as tfeat
from ishapediting_tpu_torch.edit import morph as tmorph
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.edit.fit import latent_to_planes
from torch_parity_helpers import decoder_pair, jax_step_noises, to_torch, unet_pair

torch.set_num_threads(2)

CFG = preset("tiny")
SHAPE = (1,) + CFG.latent_shape
ATOL = 1e-4
MORPH_ATOL = 1e-3


@pytest.fixture(scope="module")
def pair():
    jcfg, jparams, unet = unet_pair(dict(vars(CFG.unet)), seed=51)
    jdec, tdec = decoder_pair(CFG.plane_channels, seed=52)
    jeng = JDragEngine(jpreset("tiny"), unet_params=jparams, decoder_params=jdec)
    teng = DragEngine(CFG, unet=unet, decoder=tdec, device="cpu")
    return jeng, teng


def x0s(n=2, seed=3):
    return np.random.default_rng(seed).uniform(-0.8, 0.8, (n,) + CFG.latent_shape).astype(np.float32)


def test_ddim_reverse_sample_loop_matches_jax(pair):
    jeng, teng = pair
    x0 = x0s()
    want = jdiff.ddim_reverse_sample_loop(jeng.sched, jeng._model_fn(feat=False), jnp.asarray(x0))
    with torch.no_grad():
        got = tdiff.ddim_reverse_sample_loop(teng.sched, teng.model_fn(), to_torch(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # one reverse step alone, with its pred_xstart
    t = jnp.full((2,), 4, jnp.int32)
    jw = jdiff.ddim_reverse_sample(jeng.sched, jeng._model_fn(feat=False), jnp.asarray(x0), t)
    with torch.no_grad():
        tw = tdiff.ddim_reverse_sample(teng.sched, teng.model_fn(), to_torch(x0), torch.full((2,), 4))
    for k in ("sample", "pred_xstart"):
        np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]), atol=ATOL, err_msg=k)


CASES = {
    "generic": lambda a, b: (a, b),
    "parallel": lambda a, b: (a, 2.0 * a),
    "antiparallel": lambda a, b: (a, -0.5 * a),
    "zero_a": lambda a, b: (0.0 * a, b),
    "both_zero": lambda a, b: (0.0 * a, 0.0 * b),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("alpha", [0.3, [0.0, 0.25, 0.5, 1.0]])
def test_slerp_matches_jax(case, alpha):
    rng = np.random.default_rng(4)
    a, b = CASES[case](rng.normal(size=(4, 4, 3)).astype(np.float32),
                       rng.normal(size=(4, 4, 3)).astype(np.float32))
    want = np.asarray(jmorph.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(alpha, jnp.float32)))
    got = tmorph.slerp(to_torch(a), to_torch(b), alpha).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_morph_latents_matches_jax(pair):
    jeng, teng = pair
    x0 = x0s(seed=5)
    alphas = [0.0, 0.4, 1.0]
    want = jmorph.morph_latents(jeng.sched, jeng._model_fn(feat=False), jnp.asarray(x0[0]),
                                jnp.asarray(x0[1]), alphas)
    walls = {}
    with torch.no_grad():
        got = tmorph.morph_latents(teng.sched, teng.model_fn(), to_torch(x0[0]), to_torch(x0[1]),
                                   alphas, walls=walls)
    assert got.shape == (3,) + CFG.latent_shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MORPH_ATOL)
    assert walls["encode_s"] > 0 and walls["decode_s"] > 0


def test_engine_sample_latent_and_morph_match_jax(pair):
    """``sample_latent`` from JAX's x_T with its step draws injected, then
    ``morph`` of two such latents at 3 frames; ``n < 2`` is refused."""
    jeng, teng = pair
    lats = []
    for seed in (1, 2):
        want = np.asarray(jeng.sample_latent(seed=seed))
        x_T = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), SHAPE))
        noises = jax_step_noises(jax.random.PRNGKey(seed + 1), SHAPE, jeng.sched.num_timesteps)
        got = teng.sample_latent(latent=x_T, noises=noises)
        assert got.shape == SHAPE
        np.testing.assert_allclose(got, want, atol=ATOL)
        lats.append(want)
    want = np.asarray(jeng.morph(lats[0], lats[1], n=3))
    got = teng.morph(lats[0], lats[1], n=3)
    np.testing.assert_allclose(got, want, atol=MORPH_ATOL)
    assert teng.last_phase_walls["path"] == "morph" and teng.last_phase_walls["frames"] == 3
    with pytest.raises(ValueError, match="at least 2"):
        teng.morph(lats[0], lats[1], n=1)


@pytest.mark.parametrize("use_ddim", [False, True])
def test_p_sample_loop_snapshots_matches_jax(pair, use_ddim):
    jeng, teng = pair
    x_T = np.random.default_rng(6).normal(size=(2,) + CFG.latent_shape).astype(np.float32)
    rng = jax.random.PRNGKey(8)
    steps = (0, 4, 9)
    want = jdiff.p_sample_loop_snapshots(jeng.sched, jeng._model_fn(feat=False), jnp.asarray(x_T), rng,
                                         snapshot_steps=steps, use_ddim=use_ddim)
    noises = None if use_ddim else jax_step_noises(rng, x_T.shape, teng.sched.num_timesteps)
    with torch.no_grad():
        got = tdiff.p_sample_loop_snapshots(teng.sched, teng.model_fn(), to_torch(x_T),
                                            snapshot_steps=steps, use_ddim=use_ddim, noises=noises)
    assert got["snapshots"].shape == (3, 2) + CFG.latent_shape
    for k in ("sample", "snapshots"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)
    # the last loop index is the final sample
    np.testing.assert_array_equal(got["snapshots"][-1].numpy(), got["sample"].numpy())
    with pytest.raises(ValueError, match="loop indices"):
        tdiff.p_sample_loop_snapshots(teng.sched, teng.model_fn(), to_torch(x_T), snapshot_steps=(10,),
                                      use_ddim=True)


@pytest.mark.parametrize("use_ddim,eta", [(False, 0.0), (True, 0.0), (True, 0.5)])
def test_sample_partial_matches_jax(pair, use_ddim, eta):
    """Steps 7..2 with the regrouped features captured at every step."""
    jeng, teng = pair
    x = np.random.default_rng(7).normal(size=SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    want = jdiff.sample_partial(jeng.sched, jeng._model_fn(feat=True), jnp.asarray(x), rng, t_start=8,
                                t_stop=2, use_ddim=use_ddim, eta=eta, capture_features=True,
                                feat_postprocess=jfeat.regroup_features)
    noises = jax_step_noises(rng, SHAPE, 6)
    with torch.no_grad():
        got = tdiff.sample_partial(teng.sched, teng.model_fn(feat=True), to_torch(x), t_start=8, t_stop=2,
                                   use_ddim=use_ddim, eta=eta, capture_features=True,
                                   feat_postprocess=tfeat.regroup_features, noises=noises)
    assert got["features"].shape[0] == got["pred_xstart"].shape[0] == 6
    for k in ("sample", "pred_xstart", "features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)


def test_cli_morph_seeds_and_triplane_endpoint(tmp_path):
    """``cli.morph`` writes latents.npy and one OBJ per frame, the files
    the JAX package's writes; an endpoint
    given as the physical NCHW triplane of a latent morphs like that latent
    (alpha 0 frame), and a missing or doubled endpoint is refused."""
    out = tmp_path / "morph"
    engine, lat = tcli_morph.main([
        "--random_init", "--preset", "tiny", "--seed_a", "1", "--seed_b", "2", "--frames", "3",
        "--shape_resolution", "16", "--smooth", "2", "--out", str(out), "--device", "cpu",
    ])
    assert lat.shape == (3,) + CFG.latent_shape and np.isfinite(lat).all()
    np.testing.assert_array_equal(np.load(out / "latents.npy"), lat)
    jcli_morph.main(["--random_init", "--preset", "tiny", "--seed_a", "1", "--seed_b", "2", "--frames", "3",
                     "--shape_resolution", "16", "--smooth", "2", "--out", str(tmp_path / "j")])
    assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "j"))
    for k in range(3):
        assert os.path.getsize(out / f"frame_{k:02d}.obj") > 0
    la = engine.sample_latent(seed=1)
    planes = latent_to_planes(torch.as_tensor(la), engine.half_range, engine.middle).numpy()
    np.save(tmp_path / "a_tri.npy", planes.transpose(0, 3, 1, 2))  # [3, C, H, W]
    out2 = tmp_path / "morph2"
    _, lat2 = tcli_morph.main([
        "--random_init", "--preset", "tiny", "--tri_a", str(tmp_path / "a_tri.npy"), "--seed_b", "2",
        "--frames", "2", "--skip_decode", "--out", str(out2), "--device", "cpu",
    ])
    np.testing.assert_allclose(lat2[0], lat[0], atol=1e-5)
    assert not os.path.exists(out2 / "frame_00.obj")
    for bad in (["--seed_a", "1"], ["--seed_a", "1", "--tri_a", "x.npy", "--seed_b", "2"]):
        with pytest.raises(SystemExit):
            tcli_morph.main(["--random_init", "--preset", "tiny", "--out", str(tmp_path / "x"),
                             "--device", "cpu"] + bad)


def test_cli_generate_save_intermediate_and_npz(tmp_path):
    """The port's CLI writes what the JAX package's writes (file names,
    shapes); the intermediates are those of the same samples a plain run
    gives (the last loop index equals the saved triplane); --sharded_decode
    is taken, as the JAX package takes it with one usable device
    (tests/test_torch_cli.py holds its outputs to a run without it)."""
    common = ["--random_init", "--preset", "tiny", "--num_samples", "3", "--batch_size", "2",
              "--use_ddim", "--num_steps", "6", "--save_intermediate", "0,3,5", "--save_npz",
              "--shape_resolution", "16", "--skip_decode"]
    tout, jout = tmp_path / "t", tmp_path / "j"
    tgen.main(common + ["--save_dir", str(tout), "--device", "cpu"])
    jgen.main(common + ["--save_dir", str(jout)])
    for sub in ("", "triplanes", "intermediate_tensors"):
        assert sorted(os.listdir(tout / sub)) == sorted(os.listdir(jout / sub)), sub
    for name in os.listdir(tout / "intermediate_tensors"):
        assert np.load(tout / "intermediate_tensors" / name).shape == (6, 16, 16)
    npz = np.load(tout / "samples_3x16x16x6.npz")["arr_0"]
    for i in range(3):
        tri = np.load(tout / "triplanes" / f"{i}.npy")
        np.testing.assert_array_equal(np.load(tout / "intermediate_tensors" / f"{i}_it5.npy"), tri)
        np.testing.assert_array_equal(npz[i].transpose(2, 0, 1), tri)
    plain = tmp_path / "plain"
    tgen.main(common[:10] + ["--shape_resolution", "16", "--skip_decode", "--save_dir", str(plain),
                             "--device", "cpu"])
    for i in range(3):
        np.testing.assert_allclose(np.load(plain / "triplanes" / f"{i}.npy"),
                                   np.load(tout / "triplanes" / f"{i}.npy"), atol=1e-6)
    sharded = tmp_path / "sharded"
    tgen.main(common[:10] + ["--shape_resolution", "16", "--skip_decode", "--sharded_decode",
                             "--save_dir", str(sharded), "--device", "cpu"])
    for i in range(3):
        np.testing.assert_array_equal(np.load(sharded / "triplanes" / f"{i}.npy"),
                                      np.load(plain / "triplanes" / f"{i}.npy"))
    with pytest.raises(SystemExit, match="use_dpm"):
        tgen.main(["--random_init", "--preset", "tiny", "--use_dpm", "--save_intermediate", "1",
                   "--device", "cpu"])
