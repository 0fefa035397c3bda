"""Port parity, diffusion losses: the same numpy-seeded inputs go through the
JAX package's ``core/losses.py`` and the port's, with JAX's own noise
injected into the port. An analytic model function of (x, t) written in both
frameworks stands in for the UNet (the UNet's loss is held to JAX's in
``test_torch_train.py``). Tolerance: fp32, 1e-5 relative (1e-6 absolute
near zero), except for the decoder NLL, the term of t = 0.

The decoder NLL is the log of a bin's probability, computed as a
difference of ``approx_standard_normal_cdf`` values, i.e. of fp32 tanh
values. Beyond about three standard deviations from the mean both tanh
values lie within a few ulp of 1, and XLA's tanh and torch's round them
differently: past an argument of 7.9 XLA returns exactly 1 (the JAX package
then clips the probability to 1e-12) where torch's tanh still resolves
1 - 1.2e-7. Those bins' probabilities agree to one ulp of 1 (held below on
the probability scale, 1e-6 absolute), their logs do not; the per-sample
means of t = 0 are held to T0_RTOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu.core import losses as jl
from ishapediting_tpu.core.schedule import make_schedule as j_make_schedule
from ishapediting_tpu_torch.core import losses as tl
from ishapediting_tpu_torch.core.schedule import make_schedule
from torch_parity_helpers import to_torch

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
T0_RTOL = 1e-2
SHAPE = (3, 4, 4, 6)


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=ATOL)


def close_per_t(got, want, t):
    """Per-sample terms: RTOL where t > 0 (KL), T0_RTOL where t == 0."""
    t = np.asarray(t)
    got = np.asarray(got.detach())
    close(got[t > 0], np.asarray(want)[t > 0])
    close(got[t == 0], np.asarray(want)[t == 0], T0_RTOL)


def j_model(x, t):
    """eps = 0.3 x + t/1000, variance values tanh(x - 0.1)."""
    tt = t.astype(jnp.float32)[:, None, None, None] / 1000.0
    return jnp.concatenate([0.3 * x + tt, jnp.tanh(x - 0.1)], axis=-1), None


def t_model(x, t):
    tt = t.float()[:, None, None, None] / 1000.0
    return torch.cat([0.3 * x + tt, torch.tanh(x - 0.1)], dim=-1), None


@pytest.fixture
def data():
    rng = np.random.default_rng(3)
    x0 = np.clip(rng.normal(size=SHAPE), -1, 1).astype(np.float32)
    x0[0, 0, 0, :3] = [-1.0, 1.0, 0.9995]  # the likelihood's edge bins
    return x0, rng.normal(size=SHAPE).astype(np.float32)


def test_normal_kl_and_discretized_log_likelihood(data):
    x0, noise = data
    rng = np.random.default_rng(4)
    m2, lv1, lv2 = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))
    close(tl.normal_kl(to_torch(x0), to_torch(lv1), to_torch(m2), to_torch(lv2)),
          jl.normal_kl(x0, lv1, m2, lv2))
    means, log_scales = 0.5 * noise, -1.5 + 0.3 * lv1
    got = tl.discretized_gaussian_log_likelihood(to_torch(x0), means=to_torch(means),
                                                 log_scales=to_torch(log_scales)).numpy()
    want = np.asarray(jl.discretized_gaussian_log_likelihood(x0, means=means, log_scales=log_scales))
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=RTOL, atol=1e-6)
    resolved = want > np.log(1e-3)  # where one ulp of the cdf is < 1e-4 of the probability
    assert resolved.mean() > 0.4
    close(got[resolved], want[resolved])


@pytest.mark.parametrize("frozen", [False, True], ids=["model", "frozen_out"])
def test_vb_terms_bpd(data, frozen):
    x0, noise = data
    jsched, sched = j_make_schedule(100, "linear", ""), make_schedule(100, "linear", "")
    t = np.array([0, 41, 99], np.int32)
    x_t = np.asarray(0.8 * x0 + 0.6 * noise, np.float32)
    frozen_out = np.concatenate([0.2 * noise, np.tanh(x0)], axis=-1) if frozen else None
    want = jl.vb_terms_bpd(jsched, j_model, x0, x_t, t,
                           frozen_out=None if frozen_out is None else jnp.asarray(frozen_out))
    got = tl.vb_terms_bpd(sched, t_model, to_torch(x0), to_torch(x_t), torch.from_numpy(t).long(),
                          frozen_out=None if frozen_out is None else to_torch(frozen_out))
    close_per_t(got["output"], want["output"], t)
    close(got["pred_xstart"], want["pred_xstart"])


def test_training_losses_with_jax_noise(data):
    x0, _ = data
    jsched, sched = j_make_schedule(100, "linear", ""), make_schedule(100, "linear", "")
    t = np.array([0, 17, 98], np.int32)
    rng = jax.random.PRNGKey(7)
    want = jl.training_losses(jsched, j_model, jnp.asarray(x0), jnp.asarray(t), rng)
    noise = np.asarray(jax.random.normal(rng, x0.shape, jnp.float32))
    got = tl.training_losses(sched, t_model, to_torch(x0), torch.from_numpy(t).long(),
                             noise=to_torch(noise))
    close(got["mse"], want["mse"])
    for k in ("loss", "vb"):
        close_per_t(got[k], want[k], t)


def test_training_losses_freezes_the_mean_in_the_vb_term():
    """The vb term reaches the model only through its variance half: the
    gradient of vb with respect to the eps half's input is zero."""
    sched = make_schedule(100, "linear", "")
    x0 = torch.rand(2, 4, 4, 6) * 2 - 1
    scale = torch.ones(2, 4, 4, 6, requires_grad=True)

    def model(x, t):
        return torch.cat([scale * x, torch.tanh(x)], dim=-1), None

    terms = tl.training_losses(sched, model, x0, torch.tensor([5, 60]), noise=torch.randn_like(x0))
    (g,) = torch.autograd.grad(terms["vb"].sum(), scale)
    assert float(g.abs().max()) == 0.0


def test_prior_bpd(data):
    x0, _ = data
    close(tl.prior_bpd(make_schedule(100, "linear", ""), to_torch(x0)),
          jl.prior_bpd(j_make_schedule(100, "linear", ""), jnp.asarray(x0)))


def test_calc_bpd_loop_with_fold_in_noises(data):
    """The 1000-step chain respaced to 20 timesteps; the port gets JAX's
    ``normal(fold_in(rng, t))`` noises in loop order (t = 19 .. 0). Column
    19 of vb is t = 0's decoder NLL."""
    x0, _ = data
    jsched, sched = j_make_schedule(1000, "linear", "20"), make_schedule(1000, "linear", "20")
    rng = jax.random.PRNGKey(5)
    want = {k: np.asarray(v) for k, v in jl.calc_bpd_loop(jsched, j_model, jnp.asarray(x0), rng).items()}
    noises = [to_torch(jax.random.normal(jax.random.fold_in(rng, t), x0.shape, jnp.float32))
              for t in range(19, -1, -1)]
    got = {k: v.numpy() for k, v in tl.calc_bpd_loop(sched, t_model, to_torch(x0), noises=noises).items()}
    for k in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all(), k
    for k in ("prior_bpd", "xstart_mse", "mse"):
        close(got[k], want[k])
    close(got["vb"][:, :-1], want["vb"][:, :-1])
    close(got["vb"][:, -1], want["vb"][:, -1], T0_RTOL)
    close(got["total_bpd"], want["total_bpd"], T0_RTOL)


def test_update_ema():
    rng = np.random.default_rng(6)
    ema = [rng.normal(size=s).astype(np.float32) for s in ((3, 5), (7,))]
    params = [rng.normal(size=a.shape).astype(np.float32) for a in ema]
    want = jl.update_ema({"a": ema[0], "b": ema[1]}, {"a": params[0], "b": params[1]}, 0.99)
    got = [to_torch(a) for a in ema]
    tl.update_ema(got, [to_torch(p).requires_grad_(True) for p in params], 0.99)
    close(got[0], want["a"])
    close(got[1], want["b"])
