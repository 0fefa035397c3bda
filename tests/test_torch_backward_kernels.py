"""The backward halves of the port's two kernels: their plain twins
(``gn_silu_bwd_plain``, ``attention_bwd_plain``: the closed forms through
the kernels' partials and workspace) against the JAX package's VJPs
(``jax.vjp`` of ``pk.groupnorm_silu`` and ``pk.attention_qkv``, Pallas in
interpret mode as ``tests/test_pallas_kernels.py`` runs it) and against
autograd through the port's plain compositions; then the backward kernels
against their twins on a card (``cuda``-marked, skipped without one).

JAX is imported inside the functions that use it, so that the card cases
run where only PyTorch is installed:

    python -m pytest tests/test_torch_backward_kernels.py --noconftest -q -m cuda

Inputs come from numpy with a seed; JAX gets copies and its results are
fetched before PyTorch runs, so the two never share host memory. Tolerances
are relative to the largest gradient magnitude of the reference
(``rel_err``), stated per test.
"""

import numpy as np
import pytest
import torch

from ishapediting_tpu_torch.ops import hopper_kernels as hk
from ishapediting_tpu_torch.ops.attention import dense_qkv_attention
from ishapediting_tpu_torch.ops.nn import effective_groups

torch.set_num_threads(2)

GN_SHAPES = [(2, 8, 8, 64), (1, 6, 10, 24), (1, 16, 16, 16)]  # the last: one channel per group
# fp32: closed form against autograd, both fp32 (summation order only).
# bf16: the references round to bf16 after the norm, the FiLM and the SiLU
# (and JAX's cotangents in bf16), the closed form computes in fp32 and
# rounds dx once: a few bf16 ulps of the largest gradient.
GN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# T = 72 and 40: not multiples of the kernels' 64-row tiles; ch 320 is past
# the 64-channel chunk (five chunks and five output slices).
ATTN_CASES = [(2, 64, 4, 8), (1, 72, 2, 64), (1, 40, 2, 192), (1, 33, 1, 320)]
# fp32 as above; bf16: the references round q*s, k*s, the weights and every
# product to bf16, the closed form does not.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in fp32."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-12))


def gn_inputs(seed, shape, film):
    rng = np.random.default_rng(seed)
    n, c = shape[0], shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = (rng.normal(size=c) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    f = tuple((rng.normal(size=(n, c)) * 0.2).astype(np.float32) for _ in range(2)) if film else None
    gy = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, f, gy


def torch_gn(x, scale, bias, f, gy, dtype, device="cpu"):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(device, dt)  # noqa: E731
    return (t(x), t(scale, torch.float32), t(bias, torch.float32),
            None if f is None else (t(f[0]), t(f[1])), t(gy))


def plain_gn_grads(x, scale, bias, f, gy):
    part = hk.gn_stats_plain(x, effective_groups(x.shape[-1], 32))
    return hk.gn_silu_bwd_plain(x, part, gy, scale, bias, film=f)


@pytest.mark.parametrize("shape", GN_SHAPES)
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_bwd_plain_matches_jax_vjp(dtype, film, shape):
    """dx, dscale, dbias (and dfs, dfb) against ``jax.vjp`` of
    ``pk.groupnorm_silu`` in interpret mode, tolerance ``GN_TOL``."""
    import jax
    import jax.numpy as jnp

    from ishapediting_tpu.ops import pallas_kernels as pk

    x, scale, bias, f, gy = gn_inputs(1, shape, film)
    n, c = shape[0], shape[-1]

    def fwd(a, s, b, *film_sb):
        film_t = tuple(t.reshape(n, 1, 1, c) for t in film_sb) or None
        return pk.groupnorm_silu(a, s, b, film=film_t)

    args = (jnp.array(x, dtype), jnp.array(scale), jnp.array(bias), *(jnp.array(a, dtype) for a in (f or ())))
    want = [np.array(w) for w in jax.jit(lambda g, *a: jax.vjp(fwd, *a)[1](g))(jnp.array(gy, dtype), *args)]
    got = plain_gn_grads(*torch_gn(x, scale, bias, f, gy, getattr(torch, dtype)))
    got = [g for g in got if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(w.dtype) and tuple(g.shape) == w.shape
        assert rel_err(g.float().numpy(), w) <= GN_TOL[dtype]


@pytest.mark.parametrize("shape", GN_SHAPES)
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_bwd_plain_matches_autograd(dtype, film, shape):
    """The same gradients against autograd through ``groupnorm_silu_plain``
    (what a CPU tensor's backward runs), tolerance ``GN_TOL``."""
    x, scale, bias, f, gy = torch_gn(*gn_inputs(2, shape, film), getattr(torch, dtype))
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, *(f or ()))]
    y = hk.groupnorm_silu_plain(leaves[0], leaves[1], leaves[2], film=None if f is None else tuple(leaves[3:]))
    want = torch.autograd.grad(y, leaves, gy)
    got = [g for g in plain_gn_grads(x, scale, bias, f, gy) if g is not None]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert rel_err(g.float().numpy(), w.float().numpy()) <= GN_TOL[dtype]


def test_gn_bwd_reduce_plain_splits_rows_as_the_kernel():
    """The reduce's partials: one per row block of ``gn_bwd_geometry``, each
    summing that block's rows; together the full per-channel sums. Its
    statistics are the forward partials' merge."""
    x, scale, bias, f, gy = torch_gn(*gn_inputs(3, (2, 16, 16, 64), True), torch.float32)
    part = hk.gn_stats_plain(x, 32)
    red = hk.gn_bwd_reduce_plain(x, part, gy, scale, bias, film=f)
    sums = red.sums
    geo = hk.gn_bwd_geometry(x, 32, gy)
    assert sums.shape == (2, geo["grid"][0], 2, 64) and geo["grid"][0] > 1
    assert red.stats.shape == (2, 4, 32)
    mu, rstd = hk.merge_partials(part)
    torch.testing.assert_close(red.stats[:, 0], mu, atol=0, rtol=0)
    torch.testing.assert_close(red.stats[:, 1], rstd, atol=0, rtol=0)
    xhat = (x - mu.repeat_interleave(2, 1)[:, None, None]) * rstd.repeat_interleave(2, 1)[:, None, None]
    a = (xhat * scale + bias) * (1 + f[0][:, None, None]) + f[1][:, None, None]
    sg = torch.sigmoid(a)
    gz = gy * sg * (1 + a * (1 - sg))
    torch.testing.assert_close(sums.sum(1)[:, 0], gz.sum((1, 2)), atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(sums.sum(1)[:, 1], (gz * xhat).sum((1, 2)), atol=1e-4, rtol=1e-5)
    rows = (torch.arange(256) % geo["row_step"]) // geo["block"][1]
    block0 = rows == 0
    torch.testing.assert_close(sums[:, 0, 0], gz.reshape(2, 256, 64)[:, block0].sum(1), atol=1e-5, rtol=1e-5)


def coefficients_before(sums, scale, bias, hw, groups, film=None):
    """The [N, C] arithmetic that ran as torch ops between the two backward
    kernels before the reduce finished it itself (the oracle of
    ``test_gn_bwd_finish_plain_matches_the_torch_coefficients``): coef
    [N, 2, G], dscale [C], dbias [C], dfs [N, C], dfb [N, C], fp32."""
    n, c = sums.shape[0], sums.shape[-1]
    s1, s2 = sums.sum(1).unbind(1)
    gamma, beta = scale.float().reshape(c), bias.float().reshape(c)
    f1 = None if film is None else (1 + film[0]).reshape(n, c).float()
    k = gamma if f1 is None else gamma * f1
    coef = torch.stack([k * s1, k * s2], 1).reshape(n, 2, groups, c // groups).sum(-1) / (hw * (c // groups))
    w1, w2 = (s1, s2) if f1 is None else (f1 * s1, f1 * s2)
    dfs = dfb = None
    if film is not None:
        dfs, dfb = gamma * s2 + beta * s1, s1
    return coef.contiguous(), w2.sum(0), w1.sum(0), dfs, dfb


@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_bwd_finish_plain_matches_the_torch_coefficients(dtype, film):
    """The finished outputs of the new twins (A, B in ``stats``, dscale,
    dbias, dfs, dfb: what the reduce's finishing blocks write, in their
    order) against the torch ops that computed them before, on the same
    partials: fp32 sums in another order (1e-5 of the largest), then each
    cast once to its parameter's dtype (one bf16 ulp); mean and rstd pass
    through."""
    shape = (3, 8, 8, 64)
    dt = getattr(torch, dtype)
    x, scale, bias, f, gy = torch_gn(*gn_inputs(11, shape, film), dt)
    part = hk.gn_stats_plain(x, 32)
    red = hk.gn_bwd_reduce_plain(x, part, gy, scale, bias, film=f)
    coef, dscale, dbias, dfs, dfb = coefficients_before(red.sums, scale, bias, 64, 32, f)
    mu, rstd = hk.merge_partials(part)
    torch.testing.assert_close(red.stats[:, :2], torch.stack([mu, rstd], 1), atol=0, rtol=0)
    assert rel_err(red.stats[:, 2:].numpy(), coef.numpy()) <= 1e-5
    for got, want, like in ((red.dscale, dscale, scale), (red.dbias, dbias, bias),
                            *(((red.dfs, dfs, f[0]), (red.dfb, dfb, f[1])) if film else ())):
        assert got.dtype == like.dtype and got.shape == like.shape
        assert rel_err(got.float().numpy(), want.numpy()) <= (1e-5 if like.dtype == torch.float32 else 2 ** -8)
    if not film:
        assert red.dfs is None and red.dfb is None
    # only what is asked for
    part_need = hk.gn_bwd_reduce_plain(x, part, gy, scale, bias, film=f, need=(True, False, True, False, film))
    assert part_need.dscale is None and part_need.dfs is None and part_need.dbias is not None
    assert (part_need.dfb is not None) == film


def attn_inputs(seed, n, t, heads, ch, dtype):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(n, t, heads * 3 * ch)).astype(np.float32)
    gout = rng.normal(size=(n, t, heads * ch)).astype(np.float32)
    return torch.from_numpy(qkv).to(dtype), torch.from_numpy(gout).to(dtype)


@pytest.mark.parametrize("n,t,heads,ch", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_plain_matches_jax_vjp(dtype, n, t, heads, ch):
    """dqkv against ``jax.vjp`` of ``pk.attention_qkv`` in interpret mode,
    tolerance ``ATTN_TOL``; ``out`` is the forward's (the CPU route's)."""
    import jax
    import jax.numpy as jnp

    from ishapediting_tpu.ops import pallas_kernels as pk

    qkv, gout = attn_inputs(t + ch, n, t, heads, ch, getattr(torch, dtype))
    (want,) = jax.jit(lambda a, g: jax.vjp(lambda b: pk.attention_qkv(b, heads), a)[1](g))(
        jnp.array(qkv.float().numpy(), dtype), jnp.array(gout.float().numpy(), dtype))
    want = np.array(want)
    got = hk.attention_bwd_plain(qkv, hk.attention_qkv(qkv, heads), gout, heads)
    assert got.dtype == qkv.dtype and got.shape == qkv.shape
    assert rel_err(got.float().numpy(), want) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("n,t,heads,ch", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_plain_matches_autograd(dtype, n, t, heads, ch):
    """dqkv against autograd through ``dense_qkv_attention`` (what a CPU
    tensor's backward runs), tolerance ``ATTN_TOL``."""
    qkv, gout = attn_inputs(t * ch, n, t, heads, ch, getattr(torch, dtype))
    leaf = qkv.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(dense_qkv_attention(leaf, heads), leaf, gout)
    got = hk.attention_bwd_plain(qkv, dense_qkv_attention(qkv, heads), gout, heads)
    assert rel_err(got.float().numpy(), want.float().numpy()) <= ATTN_TOL[dtype]


def test_attention_bwd_workspace_is_logsumexp_and_d():
    """The workspace that ``attn_bwd_dq`` hands ``attn_bwd_dkdv``: each
    row's log-sum-exp of the scaled logits and D = rowsum(dO * O)."""
    qkv, gout = attn_inputs(5, 1, 40, 2, 16, torch.float32)
    out = dense_qkv_attention(qkv, 2)
    _, lse, d = hk.attn_bwd_dq_plain(qkv, out, gout, 2)
    q, k, _ = qkv.reshape(1, 40, 2, 3, 16).unbind(3)
    logits = torch.einsum("nthc,nshc->nhts", q, k) / 4.0
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(d, (gout * out).reshape(1, 40, 2, 16).sum(-1).transpose(1, 2),
                               atol=1e-5, rtol=1e-6)


def online_dq_model(qkv, out, gout, heads, warpgroups, sweep=64):
    """A tile-by-tile model of ``attn_bwd_dq``'s one key sweep: ``warpgroups``
    sum every ``warpgroups``-th key tile of ``sweep`` keys each (two on the
    Hopper route, one on the generic), each with a running row maximum m and
    sum l; dS = exp(S - m) (dP - D) rounded to qkv's dtype as the kernel
    rounds it, the dQ sums rescaled when m moves; then the partial sums merged
    and divided by the row sum. Returns (dQ [N, T, H, ch], lse, D)."""
    qs, ks, logits, dp, s, rnd = hk._attn_bwd_terms(qkv, gout, heads)
    (o,), (do,) = hk._attn_heads(out, heads, 1), hk._attn_heads(gout, heads, 1)
    d = (do * o).sum(-1).transpose(1, 2)
    n, h, t, _ = logits.shape
    parts = []
    for w in range(warpgroups):
        m = torch.full((n, h, t), -torch.inf)
        l, acc = torch.zeros((n, h, t)), torch.zeros((n, h, t, qs.shape[-1]))
        for j in range(w, -(-t // sweep), warpgroups):
            keys = slice(j * sweep, (j + 1) * sweep)
            mn = torch.maximum(m, logits[..., keys].amax(-1))
            c = torch.exp(m - mn)
            p = torch.exp(logits[..., keys] - mn[..., None])
            l = l * c + p.sum(-1)
            ds = rnd(p * (dp[..., keys] - d[..., None]))
            acc = acc * c[..., None] + torch.einsum("nhts,nshc->nhtc", ds, ks[:, keys])
            m = mn
        parts.append((m, l, acc))
    mt = torch.stack([m for m, _, _ in parts]).amax(0)
    lt = sum(l * torch.exp(m - mt) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - mt)[..., None] for m, _, a in parts)
    return (acc / lt[..., None] * s).transpose(1, 2), mt + torch.log(lt), d


@pytest.mark.parametrize(
    "dtype,n,t,heads,ch",
    [("bfloat16", 1, 136, 2, 64),  # Hopper route: three key tiles (two, one per warpgroup), a tail
     ("bfloat16", 2, 72, 1, 32),  # Hopper route: the second warpgroup's one tile is a tail
     ("float32", 1, 136, 2, 16)],  # generic route: one sweep by one CTA
)
def test_attention_bwd_online_dq_matches_plain_and_jax_vjp(dtype, n, t, heads, ch):
    """The one-sweep recurrence (``online_dq_model``) against
    ``attn_bwd_dq_plain`` (dQ, log-sum-exp, D) and, with dK and dV from
    ``attn_bwd_dkdv_plain`` on its workspace, against ``jax.vjp`` of
    ``pk.attention_qkv`` in interpret mode, tolerance ``ATTN_TOL``: the
    online form's other bf16 rounding of dS stays inside the gates."""
    import jax
    import jax.numpy as jnp

    from ishapediting_tpu.ops import pallas_kernels as pk

    dt = getattr(torch, dtype)
    qkv, gout = attn_inputs(t + 3 * ch, n, t, heads, ch, dt)
    out = hk.attention_qkv(qkv, heads)
    warpgroups = 2 if hk.attention_bwd_route(dt, ch) == "hopper" else 1
    dq, lse, d = online_dq_model(qkv, out, gout, heads, warpgroups)
    dq_p, lse_p, d_p = hk.attn_bwd_dq_plain(qkv, out, gout, heads)
    assert rel_err(dq.numpy(), dq_p.numpy()) <= ATTN_TOL[dtype]
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(d, d_p, atol=0, rtol=0)
    dk, dv = hk.attn_bwd_dkdv_plain(qkv, gout, lse, d, heads)
    got = torch.stack([dq, dk, dv], dim=3).reshape(qkv.shape).to(dt)
    (want,) = jax.jit(lambda a, g: jax.vjp(lambda b: pk.attention_qkv(b, heads), a)[1](g))(
        jnp.array(qkv.float().numpy(), dtype), jnp.array(gout.float().numpy(), dtype))
    assert rel_err(got.float().numpy(), np.array(want)) <= ATTN_TOL[dtype]


@pytest.mark.parametrize(
    "n,t,heads,ch,dtype,route,threads,grid,out_cols,chunks",
    [(8, 1024, 8, 64, torch.bfloat16, "hopper", 288, (16, 64), 64, 1),  # chairs 32^2 level, train batch 8
     (1, 1024, 8, 64, torch.bfloat16, "hopper", 288, (16, 8), 64, 1),  # the same at a drag step's batch 1
     (1, 1000, 2, 128, torch.bfloat16, "hopper", 288, (16, 2), 128, 1),  # a TMA tail; dkdv sweeps 32 rows
     (1, 256, 4, 192, torch.bfloat16, "generic", 128, (4, 4, 2), 128, 3),  # heads-by-count 16^2
     (2, 64, 4, 8, torch.float32, "generic", 128, (1, 8, 1), 16, 1),  # the tiny preset
     (1, 100, 1, 320, torch.float32, "generic", 128, (2, 1, 3), 128, 5)],
)
def test_attention_bwd_geometry(n, t, heads, ch, dtype, route, threads, grid, out_cols, chunks):
    """The route and launch shape: the Hopper route's CTA per 64 own rows and
    batch*head; the generic route's output slices of 128 channels past 64
    (ch 192 and 256: two logit passes)."""
    geo = hk.attention_bwd_geometry(n, t, heads, ch, dtype)
    assert geo["route"] == hk.attention_bwd_route(dtype, ch) == route
    assert (geo["threads"], geo["grid"], geo["out_cols"], geo["chunks"]) == (threads, grid, out_cols, chunks)
    assert max(geo["smem_dq"], geo["smem_dkdv"]) <= hk.MAX_SMEM_BYTES
    if route == "hopper":
        assert geo["sweep_dkdv"] == (32 if ch == 128 else 64)


def test_cpu_backward_runs_the_plain_composition_uncounted():
    """A CPU tensor's backward is autograd through the plain composition (the
    JAX package's VJP) and launches nothing."""
    hk.reset_launch_counts()
    x, scale, bias, f, gy = torch_gn(*gn_inputs(4, (1, 6, 10, 24), True), torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, *f)]
    got = torch.autograd.grad(hk.groupnorm_silu(leaves[0], leaves[1], leaves[2], film=tuple(leaves[3:])),
                              leaves, gy)
    want = torch.autograd.grad(hk.groupnorm_silu_plain(leaves[0], leaves[1], leaves[2],
                                                       film=tuple(leaves[3:])), leaves, gy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    qkv, gout = attn_inputs(6, 1, 40, 2, 8, torch.float32)
    leaf = qkv.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(hk.attention_qkv(leaf, 2), leaf, gout)
    (want,) = torch.autograd.grad(dense_qkv_attention(leaf, 2), leaf, gout)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert sum(hk.LAUNCHES.values()) == 0


def test_cuda_backward_wrappers_refuse_cpu_tensors():
    x, scale, bias, f, gy = torch_gn(*gn_inputs(7, (1, 4, 4, 32), False), torch.float32)
    part = hk.gn_stats_plain(x, 32)
    with pytest.raises(ValueError, match="CUDA"):
        hk.gn_silu_bwd_cuda(x, part, gy, scale, bias)
    qkv, gout = attn_inputs(8, 1, 16, 1, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        hk.attention_bwd_cuda(qkv, dense_qkv_attention(qkv, 1), gout, 1)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain twin
# ---------------------------------------------------------------------------


GN_CARD_CASES = [((2, 16, 16, 512), torch.bfloat16, True), ((1, 8, 8, 2048), torch.bfloat16, False),
                 ((1, 64, 64, 256), torch.bfloat16, True), ((1, 16, 16, 256), torch.float32, False),
                 ((1, 6, 10, 24), torch.float32, True), ((1, 16, 16, 16), torch.float32, True),
                 ((1, 8, 8, 24), torch.bfloat16, True)]  # the last: one channel per thread in bf16
GN_SUMS_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
GN_DX_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def gn_out_tol(t, dtype):
    """The tolerance of a finished output: the partials' for fp32 ones; for
    one stored in bf16 (dfs, dfb of bf16 FiLM terms) one rounding to bf16 on
    top (an element next to a rounding tie moves by an ulp, 2^-8 of itself)."""
    return GN_DX_TOL[torch.bfloat16] if t.dtype == torch.bfloat16 else GN_SUMS_TOL[dtype]


def gn_bwd_on_card(x, gy, scale, bias, f, groups):
    part = hk.gn_stats_cuda(x, groups)
    red = hk.gn_bwd_reduce_cuda(x, part, gy, scale, bias, film=f)
    dx = hk.gn_bwd_apply_cuda(x, gy, red.stats, scale, bias, film=f)
    torch.cuda.synchronize()
    return part, red, dx


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,film", GN_CARD_CASES)
def test_gn_bwd_kernels_on_card(cuda_device, shape, dtype, film):
    """gn_bwd_reduce's partials against ``gn_bwd_reduce_plain``'s (fp32 sums
    in another order, and in bf16 now and then a rounding tie of the
    emulated composition broken the other way, one bf16 ulp of one term:
    fp32 1e-4, bf16 1e-3 of the largest); its finished outputs bit for bit
    what ``gn_bwd_finish_plain`` computes from its own partials (the same
    sums in the same order) and, at the partials' tolerance (``gn_out_tol``:
    one bf16 rounding more for a gradient stored in bf16), the twin's;
    gn_bwd_apply's dx against ``gn_bwd_apply_plain`` on the kernel's
    statistics (one rounding of x's dtype: bf16 1e-2, fp32 1e-5 of the
    largest); one launch each, and a second run gives the same bits."""
    x, scale, bias, f, gy = torch_gn(*gn_inputs(9, shape, film), dtype, cuda_device)
    g = effective_groups(shape[-1], 32)
    before = dict(hk.LAUNCHES)
    part, red, dx = gn_bwd_on_card(x, gy, scale, bias, f, g)
    assert hk.LAUNCHES["gn_bwd_reduce"] == before["gn_bwd_reduce"] + 1
    assert hk.LAUNCHES["gn_bwd_apply"] == before["gn_bwd_apply"] + 1
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    xc, gyc, sc, bc = (cpu(t) for t in (x, gy, scale, bias))
    fc = None if f is None else tuple(cpu(t) for t in f)
    want = hk.gn_bwd_reduce_plain(xc, cpu(part), gyc, sc, bc, film=fc)
    assert rel_err(red.sums.cpu().numpy(), want.sums.numpy()) <= GN_SUMS_TOL[dtype]
    mean, rstd = hk.merge_partials(cpu(part))
    assert rel_err(red.stats[:, 0].cpu().numpy(), mean.numpy()) <= 1e-6
    assert rel_err(red.stats[:, 1].cpu().numpy(), rstd.numpy()) <= 1e-6
    exact = hk.gn_bwd_finish_plain(cpu(red.sums), cpu(red.stats[:, 0]), cpu(red.stats[:, 1]), sc, bc,
                                   shape[1] * shape[2], fc)
    for name, got, same, twin in zip(("stats", "dscale", "dbias", "dfs", "dfb"), red[1:], exact, want[1:]):
        assert (got is None) == (same is None) == (twin is None) == (name in ("dfs", "dfb") and not film), name
        if got is not None:
            assert torch.equal(got.cpu(), same), name
            assert got.dtype == twin.dtype and got.shape == twin.shape, name
            assert rel_err(got.float().cpu().numpy(), twin.float().numpy()) <= gn_out_tol(got, dtype), name
    dx_want = hk.gn_bwd_apply_plain(xc, gyc, cpu(red.stats), sc, bc, film=fc)
    assert rel_err(dx.float().cpu().numpy(), dx_want.float().numpy()) <= GN_DX_TOL[dtype]
    _, red2, dx2 = gn_bwd_on_card(x, gy, scale, bias, f, g)
    for a, b in zip((*red, dx), (*red2, dx2)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_gn_bwd_kernels_keep_nan_and_inf(cuda_device, dtype, bad):
    """A NaN or an inf in the cotangent leaves every output non-finite where
    the twin's is (the rounding keeps NaN NaN and inf inf: the train loop's
    NaN guard reads the gradients), and the rest within the tolerances."""
    shape = (2, 16, 16, 256)
    x, scale, bias, f, gy = torch_gn(*gn_inputs(13, shape, True), dtype, cuda_device)
    gy[0, 3, 5, 17] = bad
    gy[1, 7, 2, 200] = -bad
    part, red, dx = gn_bwd_on_card(x, gy, scale, bias, f, 32)
    cpu = lambda t: t.cpu()  # noqa: E731
    fc = tuple(cpu(t) for t in f)
    want = hk.gn_bwd_reduce_plain(cpu(x), cpu(part), cpu(gy), cpu(scale), cpu(bias), film=fc)
    dx_want = hk.gn_bwd_apply_plain(cpu(x), cpu(gy), cpu(red.stats), cpu(scale), cpu(bias), film=fc)
    pairs = [("sums", red.sums, want.sums, GN_SUMS_TOL[dtype]), ("dx", dx, dx_want, GN_DX_TOL[dtype])]
    pairs += [(k, getattr(red, k), getattr(want, k), gn_out_tol(getattr(red, k), dtype))
              for k in ("dscale", "dbias", "dfs", "dfb")]
    pairs.append(("A, B", red.stats[:, 2:], want.stats[:, 2:], GN_SUMS_TOL[dtype]))
    for name, got, w in ((n, g.float().cpu(), w.float()) for n, g, w, _ in pairs):
        assert torch.equal(got.isfinite(), w.isfinite()), name
        assert not bool(w.isfinite().all()), name
    for name, got, w, tol in pairs:
        got, w = got.float().cpu(), w.float()
        ok = w.isfinite()
        if bool(ok.any()):
            assert rel_err(got[ok].numpy(), w[ok].numpy()) <= tol, name


@pytest.mark.cuda
def test_gn_backward_launches_the_two_kernels_and_nothing_else(cuda_device):
    """A profiler trace of one ``GroupNormSiLU`` backward (bf16, FiLM, every
    gradient asked for) holds exactly the two backward kernels, once each:
    the [N, C] arithmetic runs inside them."""
    from torch.profiler import ProfilerActivity, profile

    from ishapediting_tpu_torch.utils.device import kernel_rows

    x, scale, bias, f, gy = torch_gn(*gn_inputs(12, (2, 32, 32, 256), True), torch.bfloat16, cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, *f)]
    y = hk.groupnorm_silu(leaves[0], leaves[1], leaves[2], film=tuple(leaves[3:]))
    torch.autograd.grad(y, leaves, gy, retain_graph=True)  # the build and the arrival counters
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grads = torch.autograd.grad(y, leaves, gy)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    names = sorted(e.key for e in rows)
    assert len(rows) == 2 and "gn_bwd_apply_kernel" in names[0] and "gn_bwd_reduce_kernel" in names[1], names
    assert all(e.count == 1 for e in rows)
    assert [g.dtype for g in grads] == [t.dtype for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,t,heads,ch,dtype",
    [(2, 1024, 8, 64, torch.bfloat16), (1, 256, 4, 192, torch.bfloat16), (1, 64, 4, 256, torch.bfloat16),
     (2, 64, 4, 8, torch.float32), (1, 64, 4, 16, torch.float32), (1, 100, 2, 64, torch.float32),
     (1, 72, 1, 320, torch.bfloat16), (1, 33, 1, 7, torch.float32),
     # the Hopper route at ch 32 and 128 with a TMA tail, and a drag step's batch 1
     (1, 1000, 2, 32, torch.bfloat16), (1, 1000, 2, 128, torch.bfloat16), (1, 1024, 8, 64, torch.bfloat16),
     # the generic route's streamed chunks (past its shared memory), bf16 and fp32
     (1, 72, 1, 512, torch.bfloat16), (1, 40, 1, 320, torch.float32)],
)
def test_attention_bwd_kernels_on_card(cuda_device, n, t, heads, ch, dtype):
    """attn_bwd_dq's dQ and workspace against ``attn_bwd_dq_plain`` (on the
    Hopper route also its sQ against rnd(s q), exactly), then attn_bwd_dkdv's
    dK, dV against ``attn_bwd_dkdv_plain`` on the kernel's workspace: fp32
    (FMA) 1e-5, bf16 (bf16 operands, fp32 sums) 2e-2 of the largest; one
    launch each."""
    qkv, gout = attn_inputs(n + t + ch, n, t, heads, ch, dtype)
    qkv, gout = qkv.to(cuda_device), gout.to(cuda_device)
    out = hk.attention_qkv(qkv, heads)
    before = dict(hk.LAUNCHES)
    dqkv = torch.zeros_like(qkv)
    lse, d, sq = hk.attn_bwd_dq_cuda(qkv, out, gout, heads, dqkv)
    hk.attn_bwd_dkdv_cuda(qkv, gout, lse, d, heads, dqkv, sq=sq)
    torch.cuda.synchronize()
    if hk.attention_bwd_route(dtype, ch) == "hopper":  # the workspace's sQ is rnd(s q)
        q = qkv.view(n, t, heads, 3, ch)[:, :, :, 0]
        assert torch.equal(sq.view(n, t, heads, ch), (q * ch ** -0.25).to(dtype))
    else:
        assert sq is None
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    dq, lse_p, d_p = hk.attn_bwd_dq_plain(qkv, out, gout, heads)
    dk, dv = hk.attn_bwd_dkdv_plain(qkv, gout, lse, d, heads)
    got = dqkv.float().reshape(n, t, heads, 3, ch).unbind(3)
    for name, g, w in (("lse", lse, lse_p), ("d", d, d_p), ("dq", got[0], dq), ("dk", got[1], dk),
                       ("dv", got[2], dv)):
        assert rel_err(g.cpu().numpy(), w.cpu().numpy()) <= tol, name
    assert hk.LAUNCHES["attn_bwd_dq"] == before["attn_bwd_dq"] + 1
    assert hk.LAUNCHES["attn_bwd_dkdv"] == before["attn_bwd_dkdv"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [32, 64, 128])
def test_attention_bwd_hopper_smem_matches_the_library(cuda_device, ch):
    """The Python mirror of the Hopper route's shared memory against the
    library's."""
    lib = hk._load()
    geo = hk.attention_bwd_geometry(1, 256, 2, ch, torch.bfloat16)
    assert (geo["smem_dq"], geo["smem_dkdv"]) == (lib.ishape_attn_bwd_wgmma_smem(0, ch),
                                                  lib.ishape_attn_bwd_wgmma_smem(1, ch))

