"""Port parity, samplers, on ``preset("tiny")`` from the same x_T and
weights: DDIM (eta=0), DPM-Solver++(2M) and ancestral DDPM end to end, one
``p_sample`` / ``p_sample_guidance`` step, and ``sample_loop_with_features``
step by step. Stochastic steps get JAX's own per-step noise, injected into
the port. Tolerance: final latent atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu.core import diffusion as jdiff
from ishapediting_tpu.core.schedule import make_schedule as j_make_schedule
from ishapediting_tpu.edit.features import regroup_features as j_regroup
from ishapediting_tpu.models.unet import unet_apply
from ishapediting_tpu_torch.config import preset
from ishapediting_tpu_torch.core import diffusion as tdiff
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.edit.features import regroup_features
from ishapediting_tpu_torch.parallel.sampling import sample_batches
from torch_parity_helpers import jax_step_noises, to_torch, unet_pair

torch.set_num_threads(2)

CFG = preset("tiny")
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg, jparams, model = unet_pair(dict(vars(CFG.unet)), seed=11)

    def jfn(feat_layer=-1):
        return lambda x, t: unet_apply(jcfg, jparams, x, t, feat_layer=feat_layer)

    def tfn(feat_layer=-1):
        return lambda x, t: model(x, t, feat_layer=feat_layer)

    return jfn, tfn, model


@pytest.fixture(scope="module")
def x_T():
    return np.random.default_rng(12).normal(size=(2,) + CFG.latent_shape).astype(np.float32)


def _scheds(respacing):
    return j_make_schedule(100, "linear", respacing), make_schedule(100, "linear", respacing)


@pytest.mark.parametrize("respacing,loop", [("ddim10", "ddim"), ("dpm8", "dpm"), ("10", "ddpm")])
def test_loop_end_to_end(models, x_T, respacing, loop):
    jfn, tfn, _ = models
    js, ts = _scheds(respacing)
    rng = jax.random.PRNGKey(5)
    if loop == "ddim":
        want = jdiff.ddim_sample_loop(js, jfn(), jnp.asarray(x_T), rng)
        got = tdiff.ddim_sample_loop(ts, tfn(), to_torch(x_T))
    elif loop == "dpm":
        want = jdiff.dpm_solver_sample_loop(js, jfn(), jnp.asarray(x_T))
        got = tdiff.dpm_solver_sample_loop(ts, tfn(), to_torch(x_T))
    else:
        noises = jax_step_noises(rng, x_T.shape, ts.num_timesteps)
        want = jdiff.p_sample_loop(js, jfn(), jnp.asarray(x_T), rng)
        got = tdiff.p_sample_loop(ts, tfn(), to_torch(x_T), noises=noises)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_single_steps_with_injected_noise(models, x_T):
    jfn, tfn, _ = models
    js, ts = _scheds("10")
    rng = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(rng, x_T.shape, jnp.float32))
    t = np.array([6, 0], np.int32)
    want = jdiff.p_sample(js, jfn(), jnp.asarray(x_T), jnp.asarray(t), rng)
    got = tdiff.p_sample(ts, tfn(), to_torch(x_T), torch.from_numpy(t).long(), noise=to_torch(noise))
    np.testing.assert_allclose(got["sample"].numpy(), np.asarray(want["sample"]), atol=ATOL)

    for kw in ({}, {"variance": 0.3}, {"variance_noise": 0.5}):
        jkw = {k: jnp.full(x_T.shape, v, jnp.float32) for k, v in kw.items()}
        tkw = {k: torch.full(x_T.shape, v) for k, v in kw.items()}
        want = jdiff.p_sample_guidance(
            js, jfn(1), jnp.asarray(x_T), jnp.asarray(t), noise=jnp.asarray(noise), **jkw
        )
        got = tdiff.p_sample_guidance(
            ts, tfn(1), to_torch(x_T), torch.from_numpy(t).long(), noise=to_torch(noise), **tkw
        )
        for key in ("sample", "mean", "variance", "pred_xstart", "inter_feat"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, err_msg=key)


def test_sample_loop_with_features_step_by_step(models, x_T):
    jfn, tfn, _ = models
    js, ts = _scheds("10")
    rng = jax.random.PRNGKey(9)
    w_time = 4
    want = jdiff.sample_loop_with_features(
        js, jfn(1), jnp.asarray(x_T), rng, w_time=w_time, feat_postprocess=j_regroup
    )
    noises = jax_step_noises(rng, x_T.shape, ts.num_timesteps)
    got = tdiff.sample_loop_with_features(
        ts, tfn(1), to_torch(x_T), w_time=w_time, feat_postprocess=regroup_features, noises=noises
    )
    for key in ("sample", "w", "features"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, err_msg=key)


def test_sample_batches_matches_direct_loops(models):
    """The batch loop: batch i starts from a generator seeded seed+i."""
    _, tfn, _ = models
    ts = make_schedule(100, "linear", "ddim5")
    out = sample_batches(
        ts, tfn(), num_samples=3, batch_size=2, latent_shape=CFG.latent_shape,
        device="cpu", seed=4, sampler="ddim",
    )
    assert out.shape == (3,) + CFG.latent_shape
    gen = torch.Generator().manual_seed(5)
    x1 = torch.randn((1,) + CFG.latent_shape, generator=gen)
    np.testing.assert_allclose(out[2:], tdiff.ddim_sample_loop(ts, tfn(), x1).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="unknown sampler"):
        sample_batches(ts, tfn(), num_samples=1, batch_size=1, latent_shape=CFG.latent_shape,
                       device="cpu", sampler="euler")
