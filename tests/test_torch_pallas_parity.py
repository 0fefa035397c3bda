"""Port parity, kernels: the port's plain versions against the JAX package's
Pallas kernels themselves, run in interpret mode on the CPU as
``tests/test_pallas_kernels.py`` runs them.

- ``gn_norm_plain(gn_stats_plain(x))`` (the two launches' plain versions,
  split as the ``gn_stats`` kernel splits) against ``pk.groupnorm_silu``;
- ``hk.attention_qkv`` on CPU tensors (the plain route) against
  ``pk.attention_qkv``, at the tiny preset's fp32 head dim 8 and the chairs
  model's bf16 head dim 64.

Inputs come from numpy and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishapediting_tpu.ops import pallas_kernels as pk
from ishapediting_tpu_torch.ops import hopper_kernels as hk
from ishapediting_tpu_torch.ops.nn import effective_groups

torch.set_num_threads(2)


def _gn_inputs(seed, shape, film):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = (rng.normal(size=c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    f = None
    if film:
        f = tuple((rng.normal(size=(shape[0], c)) * 0.2).astype(np.float32) for _ in range(2))
    return x, scale, bias, f


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 6, 10, 24), (1, 16, 16, 16)])
@pytest.mark.parametrize("dtype,atol", [("float32", 3e-5), ("bfloat16", 2e-2)])
def test_gn_plain_versions_match_pallas(dtype, atol, shape, film):
    """Both compute in fp32 from the same x and cast once to x's dtype, so
    they differ by fp32 summation order (fp32: 3e-5) or one bf16 rounding
    of the output (bf16: 2e-2, a bf16 ulp at |y| < 4). (1, 16, 16, 16) is the
    tiny preset's fp32 torso width: 16 groups of one channel, the VEC = 1
    path of ``gn_stats``."""
    x, scale, bias, f = _gn_inputs(3, shape, film)
    n, c = shape[0], shape[-1]
    jfilm = None if f is None else tuple(jnp.asarray(a.reshape(n, 1, 1, c), dtype) for a in f)
    want = pk.groupnorm_silu(jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(bias), film=jfilm)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    tfilm = None if f is None else tuple(torch.from_numpy(a).to(tdt) for a in f)
    part = hk.gn_stats_plain(xt, effective_groups(c, 32))
    got = hk.gn_norm_plain(xt, part, torch.from_numpy(scale), torch.from_numpy(bias), film=tfilm)
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize(
    "dtype,n,t,heads,ch,atol",
    [("float32", 2, 64, 4, 8, 2e-5), ("float32", 1, 77, 2, 8, 2e-5),
     ("bfloat16", 2, 64, 2, 64, 3e-2), ("bfloat16", 1, 40, 3, 64, 3e-2),
     # the heads-by-count chairs UNet's head dims, and one past 256
     ("float32", 1, 48, 2, 192, 2e-5), ("bfloat16", 1, 48, 2, 192, 3e-2),
     ("float32", 1, 40, 1, 256, 2e-5), ("bfloat16", 2, 40, 1, 256, 3e-2),
     ("float32", 1, 33, 1, 320, 2e-5), ("bfloat16", 1, 33, 1, 320, 3e-2)],
)
def test_attention_plain_route_matches_pallas(dtype, n, t, heads, ch, atol):
    """fp32: summation order only (2e-5). bf16: the Pallas kernel scales q
    and k in fp32 where the plain version scales them in bf16, and both
    round the weights and the output to bf16 (3e-2 on outputs of size ~1)."""
    rng = np.random.default_rng(t * 10 + ch)
    qkv = rng.normal(size=(n, t, heads * 3 * ch)).astype(np.float32)
    want = pk.attention_qkv(jnp.asarray(qkv, dtype), heads)
    hk.reset_launch_counts()
    got = hk.attention_qkv(torch.from_numpy(qkv).to(getattr(torch, dtype)), heads)
    assert sum(hk.LAUNCHES.values()) == 0  # the CPU route launches nothing
    assert got.shape == (n, t, heads * ch)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)
