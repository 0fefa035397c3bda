"""Port parity, primitives: the schedule (bit-equal), the plain versions of
the two kernels and their autograd wrappers on the CPU route, the decoder's
grid sampler. The kernels themselves are checked in test_torch_kernels.py.

Inputs come from numpy and go to both packages; JAX runs on the CPU, where
its dispatch takes the plain compositions (``pallas_enabled()`` is off).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu import config as jcfg
from ishapediting_tpu.core import diffusion as jdiff
from ishapediting_tpu.core import schedule as jsched
from ishapediting_tpu.ops import nn as jnn
from ishapediting_tpu.ops.attention import dense_qkv_attention as j_dense_attn
from ishapediting_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample
from ishapediting_tpu_torch import config as tcfg
from ishapediting_tpu_torch.core import diffusion as tdiff
from ishapediting_tpu_torch.core import schedule as tsched
from ishapediting_tpu_torch.ops import hopper_kernels as hk
from ishapediting_tpu_torch.ops import nn as tnn
from ishapediting_tpu_torch.ops.attention import dense_qkv_attention
from ishapediting_tpu_torch.ops.grid_sample import grid_sample_2d

torch.set_num_threads(2)


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


# ---------------------------------------------------------------------------
# config and schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("category", ["chairs", "tiny"])
def test_presets_match(category):
    assert dataclasses.asdict(tcfg.preset(category, 50)) == dataclasses.asdict(
        jcfg.preset(category, 50)
    )
    assert tcfg.preset("chairs").unet.torch_compute_dtype == torch.bfloat16


@pytest.mark.parametrize(
    "base,respacing",
    [(1000, ""), (1000, "200"), (1000, "ddim50"), (1000, "dpm25"), (100, "10"), (1000, "100,50")],
)
def test_schedule_bit_equal(base, respacing):
    js = jsched.make_schedule(base, "linear", respacing)
    ts = tsched.make_schedule(base, "linear", respacing)
    assert ts.num_timesteps == js.num_timesteps
    for f in tsched._COEF_FIELDS:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        assert a.dtype.itemsize == b.dtype.itemsize or f == "timestep_map", f
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=f)


@pytest.mark.parametrize("kw", [{}, {"image_size": 64, "channel_mult": "1,2", "attention_resolutions": "16"}])
def test_reference_args_config_matches_jax(kw):
    assert dataclasses.asdict(tcfg.UNetConfig.from_reference_args(**kw)) == dataclasses.asdict(
        jcfg.UNetConfig.from_reference_args(**kw)
    )


def test_q_sample_matches_jax():
    rng = np.random.default_rng(8)
    x0, noise = (rng.normal(size=(2, 4, 4, 6)).astype(np.float32) for _ in range(2))
    t = np.array([0, 37])
    want = jdiff.q_sample(jsched.make_schedule(100, "linear", "50"), jnp.asarray(x0),
                          jnp.asarray(t), jnp.asarray(noise))
    got = tdiff.q_sample(tsched.make_schedule(100, "linear", "50"), torch.from_numpy(x0),
                         torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_space_and_lambda_timesteps_equal():
    for counts in ("ddim10", "25", "10,5"):
        assert tsched.space_timesteps(1000, counts) == jsched.space_timesteps(1000, counts)
    acp = np.cumprod(1 - tsched.named_beta_schedule("linear", 1000))
    for n in (10, 25, 999):
        assert tsched.lambda_uniform_timesteps(acp, n) == jsched.lambda_uniform_timesteps(acp, n)


@pytest.mark.parametrize("respacing", ["dpm10", "ddim25", "dpm999"])
def test_dpm_solver_tables_bit_equal(respacing):
    js = jsched.make_schedule(1000, "linear", respacing)
    ts = tsched.make_schedule(1000, "linear", respacing)
    for a, b in zip(jdiff._dpm_solver_tables(js), tdiff._dpm_solver_tables(ts)):
        np.testing.assert_array_equal(b, np.asarray(a).astype(b.dtype))


# ---------------------------------------------------------------------------
# GroupNorm + FiLM + SiLU (plain version and autograd wrapper, CPU route)
# ---------------------------------------------------------------------------


def _gn_inputs(seed, shape, film):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 2 + 0.5
    c = shape[-1]
    scale = rng.normal(size=c) * 0.1 + 1.0
    bias = rng.normal(size=c) * 0.1
    f = None
    if film:
        f = (rng.normal(size=(shape[0], c)) * 0.2, rng.normal(size=(shape[0], c)) * 0.2)
    return x.astype(np.float32), scale.astype(np.float32), bias.astype(np.float32), f


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 6, 10, 24)])
@pytest.mark.parametrize("film", [False, True])
def test_groupnorm_silu_matches_jax(dtype, atol, shape, film):
    x, scale, bias, f = _gn_inputs(0, shape, film)
    if film and dtype == "float32":
        atol = 3e-5
    n, c = shape[0], shape[-1]
    jx = jnp.asarray(x, dtype)
    jfilm = None if f is None else tuple(jnp.asarray(a.reshape(n, 1, 1, c), dtype) for a in f)
    want = jnn.group_norm_silu(jx, jnp.asarray(scale), jnp.asarray(bias), film=jfilm)
    tdt = getattr(torch, dtype)
    tfilm = None if f is None else tuple(torch.from_numpy(a).to(tdt) for a in f)
    got = tnn.group_norm_silu(
        torch.from_numpy(x).to(tdt), torch.from_numpy(scale), torch.from_numpy(bias), film=tfilm
    )
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("film", [False, True])
def test_groupnorm_silu_grads_through_function(film):
    """Gradients through the autograd.Function (CPU route) equal those of
    the plain composition, for x, the affine and the FiLM terms."""
    x, scale, bias, f = _gn_inputs(2, (2, 4, 4, 32), film)

    def leaves():
        out = [torch.tensor(a, requires_grad=True) for a in (x, scale, bias)]
        if f is not None:
            out += [torch.tensor(a, requires_grad=True) for a in f]
        return out

    a = leaves()
    y = hk.groupnorm_silu(a[0], a[1], a[2], film=None if f is None else (a[3], a[4]))
    (y ** 2).sum().backward()
    b = leaves()
    y_ref = hk.groupnorm_silu_plain(b[0], b[1], b[2], film=None if f is None else (b[3], b[4]))
    (y_ref ** 2).sum().backward()
    for ga, gb in zip(a, b):
        np.testing.assert_allclose(ga.grad.numpy(), gb.grad.numpy(), atol=1e-5)


def test_group_norm_plain_matches_jax():
    x, scale, bias, _ = _gn_inputs(5, (2, 6, 6, 48), False)
    want = jnn.group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = tnn.group_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 6, 10, 24), (1, 64, 64, 32)])
@pytest.mark.parametrize("film", [False, True])
def test_per_kernel_plain_versions_compose_to_jax(shape, film):
    """The plain versions of the two kernels (split statistics, then merge
    and normalize) compose to JAX ``group_norm_silu`` in fp32 (atol 2e-5,
    3e-5 with FiLM); the merged partials give the group mean and variance."""
    x, scale, bias, f = _gn_inputs(6, shape, film)
    n, c = shape[0], shape[-1]
    g = tnn.effective_groups(c, 32)
    xt = torch.from_numpy(x)
    part = hk.gn_stats_plain(xt, g)
    geo = hk.gn_stats_geometry(n, shape[1] * shape[2], c, hk.gn_stats_vec(xt, g))
    assert part.shape == (n, g, geo["splits"], 3)
    assert torch.all(part[..., 0].sum(-1) == shape[1] * shape[2] * c // g)
    tfilm = None if f is None else tuple(torch.from_numpy(a) for a in f)
    got = hk.gn_norm_plain(xt, part, torch.from_numpy(scale), torch.from_numpy(bias), film=tfilm)
    jfilm = None if f is None else tuple(jnp.asarray(a.reshape(n, 1, 1, c)) for a in f)
    want = jnn.group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), film=jfilm)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=3e-5 if film else 2e-5)


# ---------------------------------------------------------------------------
# QKV attention (plain version and autograd wrapper, CPU route)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_attention_matches_jax(dtype, atol):
    rng = np.random.default_rng(3)
    n, t, heads, ch = 2, 16, 4, 8
    qkv = rng.normal(size=(n, t, heads * 3 * ch)).astype(np.float32)
    want = j_dense_attn(jnp.asarray(qkv, dtype), heads)
    got = hk.attention_qkv(torch.from_numpy(qkv).to(getattr(torch, dtype)), heads)
    assert got.shape == (n, t, heads * ch)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=atol)


def test_attention_grads_through_function():
    rng = np.random.default_rng(4)
    qkv = rng.normal(size=(1, 8, 2 * 3 * 4)).astype(np.float32)
    a = torch.tensor(qkv, requires_grad=True)
    (hk.attention_qkv(a, 2) ** 2).sum().backward()
    b = torch.tensor(qkv, requires_grad=True)
    (dense_qkv_attention(b, 2) ** 2).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# other primitives
# ---------------------------------------------------------------------------


def test_nn_primitives_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for jf, tf in ((jnn.avg_pool_2x, tnn.avg_pool_2x), (jnn.nearest_upsample_2x, tnn.nearest_upsample_2x)):
        np.testing.assert_allclose(_np(tf(tx)), np.asarray(jf(jx)), atol=1e-6)
    np.testing.assert_allclose(
        _np(tnn.channel_nearest_resize(tx, 9)), np.asarray(jnn.channel_nearest_resize(jx, 9)), atol=0
    )
    ts = np.array([0, 7, 999], np.int32)
    np.testing.assert_allclose(
        _np(tnn.timestep_embedding(torch.from_numpy(ts), 33)),
        np.asarray(jnn.timestep_embedding(jnp.asarray(ts), 33)),
        atol=2e-5,
    )


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(3, 9, 7, 5)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(3, 40, 2)).astype(np.float32)
    for ac in (True, False):
        want = j_grid_sample(jnp.asarray(feat), jnp.asarray(grid), align_corners=ac)
        got = grid_sample_2d(torch.from_numpy(feat), torch.from_numpy(grid), align_corners=ac)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensor_takes_plain_version_without_counting():
    hk.reset_launch_counts()
    x = torch.randn(1, 4, 4, 32)
    hk.groupnorm_silu(x, torch.ones(32), torch.zeros(32))
    hk.attention_qkv(torch.randn(1, 16, 3 * 64), 1)
    hk.bias_epilogue(torch.randn(1, 4, 4, 32), torch.randn(32), torch.randn(1, 4, 4, 32), torch.randn(32))
    assert hk.LAUNCHES == {"gn_stats": 0, "gn_norm": 0, "attention": 0, "attention_generic": 0,
                           "gn_bwd_reduce": 0, "gn_bwd_apply": 0, "attn_bwd_dq": 0, "attn_bwd_dkdv": 0,
                           "bias_add": 0, "bias_residual": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_head_dim_8_takes_plain_version(dtype):
    """fp32 or bf16 at ch 8 (the tiny preset's heads), which the card routes
    to the generic kernel: a CPU tensor takes the plain version, uncounted."""
    hk.reset_launch_counts()
    qkv = torch.from_numpy(np.random.default_rng(13).normal(size=(2, 64, 4 * 3 * 8))).to(dtype)
    assert hk.attention_route(dtype, 8) == "attention_generic"
    got = hk.attention_qkv(qkv, 4)
    torch.testing.assert_close(got, dense_qkv_attention(qkv, 4), atol=0, rtol=0)
    assert sum(hk.LAUNCHES.values()) == 0
