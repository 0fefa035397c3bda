"""The port's Hopper kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. The kernel checks need a CUDA card (a CUDA kernel
has no CPU mode) and skip without one; on the card run them with

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX).
"""

import numpy as np
import pytest
import torch

from ishapediting_tpu_torch.ops import hopper_kernels as hk
from ishapediting_tpu_torch.ops.attention import dense_qkv_attention

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


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


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        hk.groupnorm_silu_cuda(torch.randn(1, 4, 4, 32), torch.ones(32), torch.zeros(32))
    with pytest.raises(ValueError, match="CUDA"):
        hk.attention_qkv_cuda(torch.randn(1, 16, 3 * 64, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="CUDA"):
        hk.attention_qkv_cuda(torch.randn(1, 16, 3 * 8), 1)


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        hk.groupnorm_silu(torch.randn(1, 4, 4, 32, device="meta"), torch.ones(32), torch.zeros(32))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype,film",
    [((2, 16, 16, 512), torch.bfloat16, True), ((2, 8, 8, 2048), torch.bfloat16, False),
     ((1, 16, 16, 256), torch.float32, False), ((1, 6, 10, 24), torch.float32, True),
     ((1, 6, 10, 24), torch.bfloat16, True)],
)
def test_groupnorm_silu_kernel_on_card(cuda_device, shape, dtype, film):
    """bf16: |kernel - plain| <= 2e-2 + 2e-2 |plain| (the plain composition
    rounds to bf16 after each op, the kernel once); fp32: 1e-5 + 1e-5 |plain|."""
    x, scale, bias, f = _gn_inputs(8, shape, film)
    dev = cuda_device
    xt = torch.from_numpy(x).to(dev, dtype)
    args = (torch.from_numpy(scale).to(dev), torch.from_numpy(bias).to(dev))
    ft = None if f is None else tuple(torch.from_numpy(a).to(dev, dtype) for a in f)
    before = dict(hk.LAUNCHES)
    got = hk.groupnorm_silu(xt, *args, film=ft)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["gn_stats"] == before["gn_stats"] + 1
    assert hk.LAUNCHES["gn_norm"] == before["gn_norm"] + 1
    want = hk.groupnorm_silu_plain(xt, *args, film=ft)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 else dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype", [((2, 128, 128, 64), torch.bfloat16), ((1, 6, 10, 24), torch.float32)]
)
def test_groupnorm_kernels_each_against_plain(cuda_device, shape, dtype):
    """Each launch alone: the statistics partials to 1e-4 + 1e-4 |plain|
    (fp32 sums in another order); the normalize pass, given the same
    partials, to one rounding of x's dtype (bf16 1e-2 + 1e-2 |plain|)."""
    x, scale, bias, f = _gn_inputs(11, shape, True)
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    g = hk.effective_groups(shape[-1], 32)
    part = hk.gn_stats_cuda(xt, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(part, hk.gn_stats_plain(xt, g), atol=1e-4, rtol=1e-4)
    args = (torch.from_numpy(scale).to(cuda_device), torch.from_numpy(bias).to(cuda_device))
    ft = tuple(torch.from_numpy(a).to(cuda_device) for a in f)
    got = hk.gn_norm_cuda(xt, part, *args, film=ft)
    torch.cuda.synchronize()
    want = hk.gn_norm_plain(xt, part, *args, film=ft)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_groupnorm_silu_backward_on_card(cuda_device):
    x, scale, bias, f = _gn_inputs(10, (2, 8, 8, 64), True)
    leaves = [torch.tensor(a, device=cuda_device, requires_grad=True) for a in (x, scale, bias, *f)]
    y = hk.groupnorm_silu(leaves[0], leaves[1], leaves[2], film=(leaves[3], leaves[4]))
    (y ** 2).sum().backward()
    ref = [torch.tensor(a, device=cuda_device, requires_grad=True) for a in (x, scale, bias, *f)]
    y_ref = hk.groupnorm_silu_plain(ref[0], ref[1], ref[2], film=(ref[3], ref[4]))
    (y_ref ** 2).sum().backward()
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("t,heads,ch", [(1024, 8, 64), (256, 12, 64), (64, 16, 64), (77, 2, 32), (100, 1, 128)])
def test_attention_kernel_on_card(cuda_device, t, heads, ch):
    """bf16 output, |kernel - plain| <= 2e-2."""
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.normal(size=(2, t, heads * 3 * ch)).astype(np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16)
    before = hk.LAUNCHES["attention"]
    got = hk.attention_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["attention"] == before + 1
    want = dense_qkv_attention(qkv, heads)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# Launch geometry (pure Python: runs here)
# ---------------------------------------------------------------------------

CHAIRS_WIDTHS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048)


def _covered_once(starts, step, total):
    """Every index in [0, total) is start + k*step for exactly one start and k."""
    hits = np.zeros(total, dtype=np.int64)
    for s0 in starts:
        hits[s0:total:step] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("c", CHAIRS_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,hw", [(1, 8 * 8), (2, 16 * 16), (2, 64 * 64), (2, 128 * 128)])
def test_gn_norm_geometry_chairs_widths(c, dtype, n, hw):
    """At every chairs width each thread owns one whole 16-byte channel
    vector, a block stays within 1024 threads and 227 KB, and the grid-stride
    row walk visits every row of a sample exactly once."""
    vec = hk._GN_VEC[dtype]
    geo = hk.gn_norm_geometry(n, hw, c, vec)
    bdx, bdy = geo["block"]
    grid_x, grid_c, grid_n = geo["grid"]
    assert geo["vec"] == vec and bdx * vec == c and grid_c == 1 and grid_n == n
    assert 32 <= bdx * bdy <= min(hk.MAX_BLOCK_THREADS, hk._GN_NORM_THREADS)  # the launch bound
    assert geo["smem_bytes"] <= hk.MAX_SMEM_BYTES
    assert geo["row_step"] == grid_x * bdy
    starts = [bx * bdy + ty for bx in range(grid_x) for ty in range(bdy)]
    assert _covered_once(starts, geo["row_step"], hw)
    assert grid_x * grid_c * n <= 4 * hk.NUM_SMS  # a few long-lived blocks per SM


@pytest.mark.parametrize("c,vec,hw", [(24, 1, 60), (3000, 1, 10), (4096, 4, 64), (64, 8, 1)])
def test_gn_norm_geometry_generic(c, vec, hw):
    """Narrow, unvectorised and very wide C: the channel blocks cover C's
    vectors once, every block is a legal launch, every row is visited once."""
    geo = hk.gn_norm_geometry(1, hw, c, vec)
    bdx, bdy = geo["block"]
    grid_x, grid_c, _ = geo["grid"]
    assert 32 <= bdx * bdy <= hk.MAX_BLOCK_THREADS
    vectors = [cb * bdx + tx for cb in range(grid_c) for tx in range(bdx) if (cb * bdx + tx) * vec < c]
    assert sorted(vectors) == list(range(c // vec))
    starts = [bx * bdy + ty for bx in range(grid_x) for ty in range(bdy)]
    assert _covered_once(starts, geo["row_step"], hw)


def test_gn_norm_geometry_refuses_partial_vectors():
    with pytest.raises(ValueError, match="vectors"):
        hk.gn_norm_geometry(1, 4, 20, 8)


ATTN_SHAPES = [(2, 1024, 8, 64), (2, 256, 12, 64), (2, 64, 16, 64), (1, 1024, 8, 64),
               (1, 256, 12, 64), (1, 64, 16, 64)] + [
    (2, t, 2, ch) for t in (1, 65, 77, 100) for ch in (32, 64, 128)]


@pytest.mark.parametrize("n,t,heads,ch", ATTN_SHAPES)
def test_attention_geometry(n, t, heads, ch):
    """Each query row belongs to exactly one CTA's 64-row tile, no CTA lies
    wholly past T, the key tiles cover T, and a block stays within 1024
    threads and 227 KB."""
    geo = hk.attention_geometry(n, t, heads, ch)
    assert geo["threads"] == 128 + 32 <= hk.MAX_BLOCK_THREADS
    assert geo["smem_bytes"] <= hk.MAX_SMEM_BYTES
    qtiles, bh = geo["grid"]
    assert bh == n * heads
    rows = np.zeros(t, dtype=np.int64)
    for bx in range(qtiles):
        rows[bx * 64:bx * 64 + 64] += 1
    assert (rows == 1).all() and (qtiles - 1) * 64 < t
    keys = geo["keys_per_tile"]
    assert keys in (64, 128) and geo["key_tiles"] * keys >= t > (geo["key_tiles"] - 1) * keys


def test_attention_geometry_fills_the_card_at_the_main_path():
    """T = 1024 at batch 2 (B*H = 16): 256 CTAs, two of which fit on each of
    the 132 SMs (registers: 160 threads; shared memory under half of an
    SM's 228 KB), so one wave covers them; 128-key tiles except at T = 64."""
    geo = hk.attention_geometry(2, 1024, 8, 64)
    assert geo["grid"][0] * geo["grid"][1] == 256 <= 2 * hk.NUM_SMS
    assert 2 * geo["smem_bytes"] <= 228 * 1024
    assert geo["keys_per_tile"] == 128
    assert hk.attention_geometry(2, 256, 12, 64)["keys_per_tile"] == 128
    assert hk.attention_geometry(2, 64, 16, 64)["keys_per_tile"] == 64
    with pytest.raises(ValueError, match="head dim"):
        hk.attention_geometry(2, 64, 2, 48)


# ---------------------------------------------------------------------------
# Redesigned kernels on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 65, 77, 100])
def test_attention_ragged_lengths_on_card(cuda_device, t, ch):
    """T not a multiple of the 64-key tile: TMA zero-fills rows past T per
    sample and the softmax masks those keys. bf16, |kernel - plain| <= 2e-2."""
    rng = np.random.default_rng(t * 1000 + ch)
    qkv = torch.from_numpy(rng.normal(size=(2, t, 2 * 3 * ch)).astype(np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16)
    got = hk.attention_qkv(qkv, 2)
    torch.cuda.synchronize()
    want = dense_qkv_attention(qkv, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_attention_large_logits_on_card(cuda_device):
    """Inputs x8: logits of tens to hundreds, so the running max grows across
    key tiles and the online rescaling matters. Against the fp32 composition
    on the same bf16 inputs (the bf16 plain version rounds such logits by
    whole units): atol 2e-2 x 8 (V is 8x larger), rtol 1e-2 (one bf16
    rounding of the output)."""
    rng = np.random.default_rng(12)
    qkv = torch.from_numpy(rng.normal(size=(2, 1024, 8 * 3 * 64)).astype(np.float32) * 8)
    qkv = qkv.to(cuda_device, torch.bfloat16)
    got = hk.attention_qkv(qkv, 8)
    torch.cuda.synchronize()
    want = dense_qkv_attention(qkv.float(), 8)
    assert got.isfinite().all()
    torch.testing.assert_close(got.float(), want, atol=0.16, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,heads,ch", [(2, 1024, 8, 64), (2, 64, 16, 64), (2, 100, 2, 128),
                                         (2, 77, 2, 32), (2, 1, 2, 32)])
def test_attention_geometry_matches_the_library(cuda_device, n, t, heads, ch):
    """The Python mirror of the kernel's shared-memory size is the library's."""
    geo = hk.attention_geometry(n, t, heads, ch)
    assert hk._load().ishape_attention_smem(ch, geo["keys_per_tile"]) == geo["smem_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("c", CHAIRS_WIDTHS)
def test_groupnorm_silu_chairs_widths_on_card(cuda_device, c, film):
    """Every chairs width in bf16, each launch alone and both together, at
    the tolerances of the tests above."""
    x, scale, bias, f = _gn_inputs(c, (2, 16, 16, c), film)
    dev = cuda_device
    xt = torch.from_numpy(x).to(dev, torch.bfloat16)
    args = (torch.from_numpy(scale).to(dev), torch.from_numpy(bias).to(dev))
    ft = None if f is None else tuple(torch.from_numpy(a).to(dev, torch.bfloat16) for a in f)
    g = hk.effective_groups(c, 32)
    part = hk.gn_stats_cuda(xt, g)
    got = hk.gn_norm_cuda(xt, part, *args, film=ft)
    torch.cuda.synchronize()
    want = hk.gn_norm_plain(xt, part, *args, film=ft)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)
    whole = hk.groupnorm_silu(xt, *args, film=ft)
    torch.cuda.synchronize()
    want = hk.groupnorm_silu_plain(xt, *args, film=ft)
    torch.testing.assert_close(whole.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_silu_large_negative_on_card(cuda_device, dtype):
    """Pre-activations from about -300 to +50 (FiLM shift far below zero):
    the fast SiLU stays finite (-0 where e^-t overflows) and matches the
    plain version in fp32 arithmetic with one cast at the end (the bf16
    composition rounds FiLM terms of size 30 to 0.125 before they cancel):
    fp32 1e-5 + 1e-5|plain|, bf16 one rounding, 1e-2 + 1e-2|plain|; the
    fp32 output head shape."""
    shape = (2, 16, 16, 256)
    x, scale, bias, f = _gn_inputs(21, shape, True)
    dev = cuda_device
    xt = torch.from_numpy(x * 4).to(dev, dtype)
    args = (torch.from_numpy(scale * 10).to(dev), torch.from_numpy(bias).to(dev))
    shift = np.linspace(-250.0, 0.0, shape[-1], dtype=np.float32)[None].repeat(2, 0)
    ft = (torch.from_numpy(f[0]).to(dev, dtype), torch.from_numpy(shift).to(dev, dtype))
    got = hk.groupnorm_silu(xt, *args, film=ft)
    torch.cuda.synchronize()
    assert got.isfinite().all()
    part = hk.gn_stats_plain(xt, hk.effective_groups(shape[-1], 32))
    want = hk.gn_norm_plain(xt, part, *args, film=ft)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# gn_stats launch geometry (pure Python: runs here)
# ---------------------------------------------------------------------------

BF16, FP32 = torch.bfloat16, torch.float32
# Every (H, W, C, dtype) at which one chairs UNet forward calls
# groupnorm_silu (21 pairs; test_chairs_gn_calls_are_the_listed_pairs
# records them from a forward on the meta device).
CHAIRS_GN = [
    (8, 8, 1024, BF16), (64, 64, 256, BF16), (128, 128, 256, BF16), (32, 32, 512, BF16),
    (16, 16, 768, BF16), (64, 64, 512, BF16), (128, 128, 512, BF16), (32, 32, 256, BF16),
    (16, 16, 512, BF16), (8, 8, 768, BF16), (8, 8, 2048, BF16), (32, 32, 768, BF16),
    (8, 8, 1792, BF16), (16, 16, 1024, BF16), (16, 16, 1792, BF16), (16, 16, 1536, BF16),
    (16, 16, 1280, BF16), (32, 32, 1280, BF16), (32, 32, 1024, BF16), (64, 64, 768, BF16),
    (128, 128, 256, FP32),
]


def test_chairs_gn_calls_are_the_listed_pairs(monkeypatch):
    """One chairs forward on the meta device, with the kernels' wrappers
    replaced by recorders: its GroupNorm-SiLU inputs are CHAIRS_GN (71
    calls per forward) and its attention inputs bf16 at head dim 64."""
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import UNetModel, kernel_calls_per_forward

    gn, attn = [], []

    def gn_rec(x, *args, **kw):
        gn.append((*x.shape[1:], x.dtype))
        return torch.empty_like(x)

    def attn_rec(qkv, heads):
        attn.append((qkv.dtype, qkv.shape[-1] // (3 * heads)))
        return qkv.new_empty(*qkv.shape[:2], qkv.shape[-1] // 3)

    monkeypatch.setattr(hk, "groupnorm_silu", gn_rec)
    monkeypatch.setattr(hk, "attention_qkv", attn_rec)
    cfg = preset("chairs")
    with torch.device("meta"):
        unet = UNetModel(cfg.unet)
        with torch.no_grad():
            unet(torch.empty((2,) + cfg.latent_shape), torch.zeros(2, dtype=torch.long))
    assert sorted(set(gn), key=str) == sorted(CHAIRS_GN, key=str)
    assert (len(gn), len(attn)) == kernel_calls_per_forward(cfg.unet) == (71, 16)
    assert set(attn) == {(BF16, 64)} and hk.attention_route(BF16, 64) == "attention"


def test_heads_by_count_chairs_calls(monkeypatch):
    """The heads-by-count chairs UNet (``from_reference_args(
    num_head_channels=-1)``: 4 heads per attention block) on the meta
    device, wrappers replaced by recorders: its attention inputs are bf16 at
    head dim 128 (5 calls, 32^2, the wgmma kernel), 192 (5, 16^2) and 256
    (6, 8^2 and the middle block), the last two the generic kernel's, as
    ``attention_head_dims`` lists them; 71 GroupNorm-SiLU calls, as at
    chairs width with heads of 64."""
    from ishapediting_tpu_torch.config import PipelineConfig, UNetConfig
    from ishapediting_tpu_torch.models.unet import (
        UNetModel, attention_head_dims, kernel_calls_per_forward,
    )

    gn, attn = [], []

    def gn_rec(x, *args, **kw):
        gn.append(x.shape)
        return torch.empty_like(x)

    def attn_rec(qkv, heads):
        attn.append((qkv.dtype, qkv.shape[1], heads, qkv.shape[-1] // (3 * heads)))
        return qkv.new_empty(*qkv.shape[:2], qkv.shape[-1] // 3)

    monkeypatch.setattr(hk, "groupnorm_silu", gn_rec)
    monkeypatch.setattr(hk, "attention_qkv", attn_rec)
    cfg = PipelineConfig(unet=UNetConfig.from_reference_args(num_head_channels=-1))
    with torch.device("meta"):
        unet = UNetModel(cfg.unet)
        with torch.no_grad():
            unet(torch.empty((2,) + cfg.latent_shape), torch.zeros(2, dtype=torch.long))
    dims = [a[3] for a in attn]
    assert dims == attention_head_dims(cfg.unet)
    assert sorted(set(attn)) == sorted({(BF16, 1024, 4, 128), (BF16, 256, 4, 192),
                                        (BF16, 64, 4, 256)})
    assert (dims.count(128), dims.count(192), dims.count(256)) == (5, 5, 6)
    assert (len(gn), len(attn)) == kernel_calls_per_forward(cfg.unet) == (71, 16)
    routes = [hk.attention_route(BF16, ch) for ch in dims]
    assert routes.count("attention") == 5 and routes.count("attention_generic") == 11


def _check_gn_stats_geometry(n, hw, c, vec):
    geo = hk.gn_stats_geometry(n, hw, c, vec)
    bdx, bdy = geo["block"]
    grid_x, grid_c, grid_n = geo["grid"]
    cs, clusters = geo["cluster"], geo["clusters"]
    assert grid_n == n and geo["vec"] == vec
    # At most 32 partials per (sample, group); the clusters tile grid x.
    assert geo["splits"] == grid_c * clusters <= 32
    assert 1 <= cs <= 8 and grid_x == cs * clusters and grid_x % cs == 0
    # A legal block within the kernel's launch bound and shared memory.
    assert 32 <= bdx * bdy <= min(hk.MAX_BLOCK_THREADS, hk._GN_STATS_THREADS)
    assert geo["smem_bytes"] <= hk.MAX_SMEM_BYTES
    # Channel blocks cover the row's vectors once, none of them empty.
    vpr = c // vec
    vectors = [cb * bdx + tx for cb in range(grid_c) for tx in range(bdx) if cb * bdx + tx < vpr]
    assert sorted(vectors) == list(range(vpr)) and (grid_c - 1) * bdx < vpr
    # The grid-stride walk visits every row of a sample exactly once, and
    # every cluster gets rows (no empty partial within a channel block).
    assert geo["row_step"] == grid_x * bdy
    starts = [bx * bdy + ty for bx in range(grid_x) for ty in range(bdy)]
    assert _covered_once(starts, geo["row_step"], hw)
    rows_of_cluster = np.bincount(
        (np.arange(hw) % geo["row_step"]) // bdy // cs, minlength=clusters)
    assert len(rows_of_cluster) == clusters and (rows_of_cluster > 0).all()
    return geo


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("h,w,c,dtype", CHAIRS_GN)
def test_gn_stats_geometry_chairs(h, w, c, dtype, n):
    """Every chairs (shape, dtype) at batch 1, 2 and 8: one 16-byte vector
    per thread (one channel block), rows covered once, S <= 32, clusters of
    at most 8 that tile the grid, a few long-lived blocks per SM."""
    geo = _check_gn_stats_geometry(n, h * w, c, hk._GN_VEC[dtype])
    assert geo["grid"][1] == 1 and geo["block"][0] * geo["vec"] == c
    assert geo["grid"][0] * n <= 4 * hk.NUM_SMS


@pytest.mark.parametrize(
    "n,hw,c,vec", [(1, 60, 24, 1), (1, 256, 16, 1), (2, 64, 32, 1), (1, 10, 3000, 1),
                   (1, 6, 3000, 4), (1, 64, 4096, 4), (1, 1, 64, 8), (3, 5, 7, 1),
                   (1, 16384, 64, 8), (16, 4096, 512, 8)],
)
def test_gn_stats_geometry_generic(n, hw, c, vec):
    """Narrow, unvectorised, very wide (several channel blocks) and tiny
    inputs keep the same invariants."""
    _check_gn_stats_geometry(n, hw, c, vec)


def test_gn_stats_geometry_refuses_partial_vectors():
    with pytest.raises(ValueError, match="vectors"):
        hk.gn_stats_geometry(1, 4, 20, 8)


@pytest.mark.parametrize("shape,groups", [((1, 2, 3, 3000), 30), ((2, 5, 7, 24), 24),
                                          ((2, 8, 8, 64), 32), ((1, 16, 16, 16), 16)])
def test_gn_stats_plain_partials_merge_to_group_stats(shape, groups):
    """The split partials (several channel blocks at C = 3000, whose groups
    straddle a block edge, with count-0 partials) merge to each group's
    count, mean and biased variance."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 2).astype(np.float32))
    part = hk.gn_stats_plain(x, groups)
    count, mean, m2 = part.unbind(-1)
    total = count.sum(-1)
    mu = (count * mean).sum(-1) / total
    var = (m2.sum(-1) + (count * (mean - mu[..., None]).square()).sum(-1)) / total
    xg = x.reshape(shape[0], -1, groups, shape[-1] // groups).double()
    assert torch.all(total == xg.shape[1] * xg.shape[3])
    torch.testing.assert_close(mu.double(), xg.mean(dim=(1, 3)), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(var.double(), xg.var(dim=(1, 3), correction=0), atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# Generic attention: routing and launch geometry (pure Python: runs here)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,ch,route",
    [(BF16, 32, "attention"), (BF16, 64, "attention"), (BF16, 128, "attention"),
     (BF16, 8, "attention_generic"), (BF16, 16, "attention_generic"),
     (BF16, 48, "attention_generic"), (FP32, 8, "attention_generic"),
     (FP32, 64, "attention_generic"), (FP32, 1, "attention_generic"),
     (FP32, 128, "attention_generic"), (FP32, 129, "attention_generic"),
     (BF16, 256, "attention_generic")],
)
def test_attention_route(dtype, ch, route):
    assert hk.attention_route(dtype, ch) == route


@pytest.mark.parametrize("dtype,ch,err", [(FP32, 0, ValueError), (torch.float16, 64, TypeError)])
def test_attention_route_refuses(dtype, ch, err):
    with pytest.raises(err):
        hk.attention_route(dtype, ch)


def _check_generic_geometry(geo, n, t, heads, ch, dtype):
    """The padded head dim is the next multiple of 16 >= ch; each query row
    is in exactly one 64-row tile and each key in one key tile; on the fast
    path (fp32 up to 128, bf16 up to 256) the O accumulator's bucket is the
    least of its dtype's buckets >= chp and one slice covers every channel,
    past it slices of 256 cover each channel once; shared memory within
    227 KB."""
    chp = geo["chp"]
    assert chp % 16 == 0 and ch <= chp < ch + 16
    qtiles, bh, slices = geo["grid"]
    assert bh == n * heads and (qtiles - 1) * 64 < t <= qtiles * 64
    keys = geo["keys_per_tile"]
    assert (geo["key_tiles"] - 1) * keys < t <= geo["key_tiles"] * keys
    assert geo["threads"] == 128 and 0 < geo["smem_bytes"] <= hk.MAX_SMEM_BYTES
    buckets = (16, 32, 48, 64, 96, 128) + (() if dtype == FP32 else (192, 256))
    if chp <= buckets[-1]:
        split = geo["split"]
        assert not geo["chunked"] and slices == split and split in (1, 2, 4)
        assert split == 1 or (2 * split <= geo["key_tiles"] and split * qtiles * bh <= 66)
        if split < 4 and 4 * split <= geo["key_tiles"]:
            assert 2 * split * qtiles * bh > 66  # doubled as far as it goes
        assert geo["bucket"] == min(b for b in buckets if b >= chp)
        assert keys == (32 if dtype == FP32 or geo["bucket"] > 128 else 64)
        assert geo["stages"] == (3 if dtype == FP32 else 4)
    else:
        assert geo["chunked"] and geo["bucket"] == 256 and keys == 32
        assert (slices - 1) * 256 < chp <= slices * 256


@pytest.mark.parametrize("dtype", [FP32, BF16])
@pytest.mark.parametrize("n,t,heads,ch", [(2, 1024, 8, 64), (2, 64, 4, 8), (1, 1, 1, 1),
                                          (2, 65, 3, 40), (1, 77, 2, 128), (2, 256, 12, 9),
                                          (2, 256, 4, 192), (2, 64, 4, 256), (2, 100, 2, 320)])
def test_attention_generic_geometry(n, t, heads, ch, dtype):
    geo = hk.attention_generic_geometry(n, t, heads, ch, dtype)
    _check_generic_geometry(geo, n, t, heads, ch, dtype)


@pytest.mark.parametrize("dtype,n,t,heads,ch,split",
                         [(BF16, 2, 256, 4, 192, 2), (BF16, 1, 256, 4, 192, 4),
                          (BF16, 2, 64, 4, 256, 1), (BF16, 2, 64, 4, 8, 1),
                          (FP32, 2, 1024, 8, 64, 1), (FP32, 2, 64, 16, 64, 1),
                          (FP32, 2, 256, 12, 64, 1), (FP32, 1, 512, 4, 8, 2)])
def test_attention_generic_split(dtype, n, t, heads, ch, split):
    """The cluster split at the smoke's shapes: the heads-by-count chairs
    input bf16 ch 192 over T=256 (8 key tiles of 32; 32 CTAs at batch 2:
    2, as 4 would fill more than half the SMs; 16 at batch 1: 4, two tiles
    each), ch 256 over T=64 (two key tiles: 1), bf16 ch 8 at T=64 (one key
    tile of 64: 1), fp32 (tiles of 32 keys) at the chairs shapes (1), and a
    small fp32 grid with 16 key tiles (32 CTAs: 2)."""
    assert hk.attention_generic_geometry(n, t, heads, ch, dtype)["split"] == split


@pytest.mark.parametrize("dtype", [FP32, BF16])
def test_attention_generic_geometry_every_head_dim(dtype):
    """Every head dim from 1 to 320: the rules of ``_check_generic_geometry``,
    and the shared memory of the source's layout in rows of chp + pad
    elements (4 bytes and a pad of 4 for fp32, 2 and 8 for bf16): Q and the
    K/V ring, and for fp32 the lo halves of Q, K and V; chunked, Q and K
    chunks of 64 channels and a V slice of 256, twice for fp32; bf16 at ch
    192 and 256, the TMA layout (unpadded rows after 1 KB of slack). The
    largest fast-path layouts: fp32 at chp 128, (128 + 6*32 + 2*32) rows of
    132 floats, 202,752 bytes; bf16 at chp 256 (ch 241 to 255), (64 + 8*32)
    rows of 264, 168,960; the TMA layout at ch 256, 1024 + 320 rows of 512
    bytes, 164,864."""
    elt, pad, lo, stages = (4, 4, 2, 3) if dtype == FP32 else (2, 8, 1, 4)
    for ch in range(1, 321):
        geo = hk.attention_generic_geometry(2, 77, 3, ch, dtype)
        _check_generic_geometry(geo, 2, 77, 3, ch, dtype)
        keys, chp = geo["keys_per_tile"], geo["chp"]
        assert geo["tma"] == (dtype == BF16 and ch in (192, 256))
        if geo["chunked"]:
            want = elt * lo * ((64 + keys) * (64 + pad) + keys * (256 + pad))
        elif geo["tma"]:  # 1 KB of alignment slack, unpadded rows
            want = 1024 + elt * (64 + 2 * stages * keys) * ch
        else:
            want = elt * (lo * 64 + 2 * stages * keys + (lo - 1) * 2 * keys) * (chp + pad)
        assert geo["smem_bytes"] == want
    assert hk.attention_generic_geometry(1, 64, 1, 128, FP32)["smem_bytes"] == 202752
    assert hk.attention_generic_geometry(1, 64, 1, 250, BF16)["smem_bytes"] == 168960
    assert hk.attention_generic_geometry(1, 64, 1, 256, BF16)["smem_bytes"] == 164864


def test_attention_generic_geometry_refuses():
    with pytest.raises(ValueError):
        hk.attention_generic_geometry(1, 64, 1, 0)
    with pytest.raises(TypeError):
        hk.attention_generic_geometry(1, 64, 1, 64, torch.float16)


# ---------------------------------------------------------------------------
# Slice 3 kernels on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 65, 1024])
@pytest.mark.parametrize("dtype,ch", [(FP32, 8), (FP32, 16), (FP32, 32), (FP32, 64), (FP32, 128),
                                      (BF16, 8), (BF16, 16), (BF16, 40), (BF16, 48), (BF16, 192),
                                      (BF16, 256), (FP32, 192), (FP32, 256), (FP32, 320),
                                      (BF16, 320)])
def test_attention_generic_on_card(cuda_device, dtype, ch, t):
    """The generic kernel against dense_qkv_attention on the same inputs:
    fp32 |kernel - plain| <= 1e-4 (summation order), bf16 2e-2 (the
    wgmma kernel's tolerance). Only ``attention_generic`` counts."""
    heads = 2
    rng = np.random.default_rng(t * 1000 + ch)
    qkv = torch.from_numpy(rng.normal(size=(2, t, heads * 3 * ch)).astype(np.float32))
    qkv = qkv.to(cuda_device, dtype)
    before = dict(hk.LAUNCHES)
    got = hk.attention_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["attention_generic"] == before["attention_generic"] + 1
    assert hk.LAUNCHES["attention"] == before["attention"]
    want = dense_qkv_attention(qkv, heads)
    atol = 1e-4 if dtype == FP32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t,heads,ch", [(77, 2, 40), (100, 3, 1), (130, 2, 100), (64, 4, 8)])
def test_attention_generic_any_head_dim_on_card(cuda_device, t, heads, ch):
    """Head dims that are not multiples of 16 (padded to chp; odd ones load
    element by element), fp32, inputs x4 so that the running max moves
    across key tiles: 1e-4 + 1e-5|plain|."""
    rng = np.random.default_rng(t + ch)
    qkv = torch.from_numpy(rng.normal(size=(2, t, heads * 3 * ch)).astype(np.float32) * 4)
    qkv = qkv.to(cuda_device)
    got = hk.attention_qkv(qkv, heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, dense_qkv_attention(qkv, heads), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("t,heads,ch", [(97, 2, 191), (40, 1, 257), (70, 2, 333), (33, 1, 600),
                                        (130, 2, 144)])
def test_attention_generic_large_head_dims_on_card(cuda_device, t, heads, ch):
    """fp32 past the fast path (chp > 128: the chunked path, output slices
    of 256 past 256) and at a head dim that is not a multiple of 16:
    1e-4 + 1e-5|plain| against the plain fp32 version. Inputs unscaled: at
    x4 the plain fp32 version's own rounding reaches that tolerance at these
    head dims (``tools/attention_accuracy.py``), so it cannot referee there;
    the next test holds the kernel to float64 at x4 instead."""
    rng = np.random.default_rng(t + ch)
    qkv = torch.from_numpy(rng.normal(size=(2, t, heads * 3 * ch)).astype(np.float32))
    qkv = qkv.to(cuda_device)
    got = hk.attention_qkv(qkv, heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, dense_qkv_attention(qkv, heads), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,t,heads,ch,split",
                         [(FP32, 1, 512, 1, 64, 4), (FP32, 1, 700, 1, 9, 4),
                          (FP32, 2, 333, 2, 100, 2), (BF16, 1, 600, 1, 40, 4),
                          (BF16, 2, 256, 4, 192, 2), (BF16, 1, 256, 4, 256, 4),
                          (BF16, 1, 1000, 2, 8, 2)])
def test_attention_generic_cluster_split_on_card(cuda_device, dtype, n, t, heads, ch, split):
    """Small grids whose key tiles a cluster of CTAs shares (the split the
    geometry names), ragged last tiles and odd head dims among them: the
    merged output within the kernel's tolerance of the plain version
    (fp32 1e-4 + 1e-5|plain|, bf16 2e-2)."""
    assert hk.attention_generic_geometry(n, t, heads, ch, dtype)["split"] == split
    rng = np.random.default_rng(t + ch + n)
    qkv = torch.from_numpy(rng.normal(size=(n, t, heads * 3 * ch)).astype(np.float32))
    qkv = qkv.to(cuda_device, dtype)
    got = hk.attention_qkv(qkv, heads)
    torch.cuda.synchronize()
    want = dense_qkv_attention(qkv, heads)
    if dtype == FP32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t,heads,ch", [(130, 2, 100), (97, 2, 191), (70, 2, 333)])
def test_attention_generic_fp32_against_float64_on_card(cuda_device, t, heads, ch):
    """fp32 at inputs x4 (logits of size ~50, the running max moving across
    tiles): within 1e-4 of ``dense_qkv_attention`` evaluated in float64."""
    rng = np.random.default_rng(t + ch)
    qkv = torch.from_numpy(rng.normal(size=(2, t, heads * 3 * ch)).astype(np.float32) * 4)
    qkv = qkv.to(cuda_device)
    got = hk.attention_qkv(qkv, heads)
    torch.cuda.synchronize()
    exact = dense_qkv_attention(qkv.double(), heads)
    torch.testing.assert_close(got.double(), exact, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t,heads,ch", [(256, 4, 192), (64, 4, 256), (77, 2, 40), (65, 3, 9),
                                        (100, 1, 320)])
def test_attention_generic_bf16_head_dims_on_card(cuda_device, t, heads, ch):
    """bf16 at the heads-by-count chairs shapes (ch 192 over T=256, ch 256
    over T=64), at head dims that are not multiples of 16 and past 256:
    within 2e-2 of the plain version (the wgmma kernel's tolerance)."""
    rng = np.random.default_rng(t * 7 + ch)
    qkv = torch.from_numpy(rng.normal(size=(2, t, heads * 3 * ch)).astype(np.float32))
    qkv = qkv.to(cuda_device, BF16)
    before = dict(hk.LAUNCHES)
    got = hk.attention_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["attention_generic"] == before["attention_generic"] + 1
    want = dense_qkv_attention(qkv, heads)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [FP32, BF16])
@pytest.mark.parametrize("ch", [1, 8, 9, 16, 40, 64, 100, 128, 144, 192, 256, 320, 600])
def test_attention_generic_geometry_matches_the_library(cuda_device, ch, dtype):
    geo = hk.attention_generic_geometry(1, 64, 1, ch, dtype)
    code = 0 if dtype == FP32 else 1
    assert hk._load().ishape_attention_generic_smem(ch, code) == geo["smem_bytes"]


def _var_form(part):
    """(count, mean, M2) as (count, mean, M2/count): O(1) values."""
    return torch.cat([part[..., :2], part[..., 2:] / part[..., :1]], dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("h,w,c,dtype", CHAIRS_GN)
def test_gn_stats_chairs_on_card(cuda_device, h, w, c, dtype, n):
    """Every chairs (shape, dtype): the kernel's partials one by one against
    gn_stats_plain (same split), and the merged group statistics against
    torch.var_mean, each to 1e-4 + 1e-4|plain| on (count, mean, M2/count)."""
    rng = np.random.default_rng(h * c + n)
    x = torch.from_numpy((rng.normal(size=(n, h, w, c)) * 2 + 0.5).astype(np.float32))
    x = x.to(cuda_device, dtype)
    g = hk.effective_groups(c, 32)
    part = hk.gn_stats_cuda(x, g)
    torch.cuda.synchronize()
    want = hk.gn_stats_plain(x, g)
    assert part.shape == want.shape and part.shape[2] <= 32
    torch.testing.assert_close(_var_form(part), _var_form(want), atol=1e-4, rtol=1e-4)
    count, mean, m2 = part.double().unbind(-1)
    total = count.sum(-1)
    mu = (count * mean).sum(-1) / total
    var = (m2.sum(-1) + (count * (mean - mu[..., None]).square()).sum(-1)) / total
    v_ref, mu_ref = torch.var_mean(x.double().reshape(n, h * w, g, c // g), dim=(1, 3), correction=0)
    torch.testing.assert_close(mu, mu_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(var, v_ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# Slice 4: gradients through the kernels' autograd Functions, device marching
# ---------------------------------------------------------------------------

# Attention inputs of one chairs forward (T, heads; head dim 64, bf16) and of
# the fp32 UNets run on the card: the edit-gate toy (middle block, head dim
# 16) and the tiny preset (head dim 8).
CHAIRS_ATTN = [(1024, 8), (256, 12), (64, 16)]
FP32_ATTN = [(64, 4, 16), (64, 4, 8)]
# The generic kernel's bf16 inputs of the heads-by-count chairs UNet
# (num_head_channels -1, 4 heads): 16^2 at ch 192, 8^2 at ch 256.
HEADS_BY_COUNT_ATTN = [(256, 4, 192), (64, 4, 256)]
# GroupNorm-SiLU inputs of the fp32 UNets (toy edit gate; tiny preset).
FP32_GN = [(16, 16, 32), (8, 8, 64), (8, 8, 128), (16, 16, 96), (16, 16, 16), (8, 8, 32),
           (8, 8, 48), (16, 16, 48)]


def grad_pair(fn, plain, inputs, seed):
    """Gradients of sum(out * r) with respect to every input, through ``fn``
    (the autograd Function: kernel forward, plain recompute backward) and
    through ``plain`` (autograd through the composition), on the same CUDA
    inputs and the same random cotangent r."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    ref = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    r = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(seed),
                    device=out.device).to(out.dtype)
    got = torch.autograd.grad((out * r).float().sum(), leaves)
    want = torch.autograd.grad((plain(*ref) * r).float().sum(), ref)
    return got, want


def _assert_grads_close(got, want, rel):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and bool(g.isfinite().all())
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=rel * max(scale, 1e-6), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("h,w,c,dtype", CHAIRS_GN)
def test_groupnorm_silu_grad_chairs_on_card(cuda_device, h, w, c, dtype, n):
    """d/d(x, scale, bias, FiLM) through ``groupnorm_silu`` (gn_stats +
    gn_norm forward) against autograd through the plain composition, at
    every chairs input, batch 1 and 8: within 1e-2 (bf16) / 1e-5 (fp32) of
    the largest gradient. The backward recomputes the plain forward, so the
    two differ only through the forward's rounding into y (none: y's value
    does not enter the gradient of sum(y * r))."""
    rng = np.random.default_rng(h * c + n)
    x = torch.from_numpy((rng.normal(size=(n, h, w, c)) * 2 + 0.5).astype(np.float32)).to(cuda_device, dtype)
    scale = torch.from_numpy((rng.normal(size=c) * 0.1 + 1).astype(np.float32)).to(cuda_device)
    bias = torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32)).to(cuda_device)
    fs, fb = (torch.from_numpy((rng.normal(size=(n, c)) * 0.2).astype(np.float32)).to(cuda_device, dtype)
              for _ in range(2))
    before = dict(hk.LAUNCHES)
    got, want = grad_pair(lambda a, s, b, f1, f2: hk.groupnorm_silu(a, s, b, film=(f1, f2)),
                          lambda a, s, b, f1, f2: hk.groupnorm_silu_plain(a, s, b, film=(f1, f2)),
                          (x, scale, bias, fs, fb), seed=c)
    torch.cuda.synchronize()
    # one forward launch each; the backward launches no kernel
    assert hk.LAUNCHES["gn_stats"] == before["gn_stats"] + 1
    assert hk.LAUNCHES["gn_norm"] == before["gn_norm"] + 1
    _assert_grads_close(got, want, 1e-2 if dtype == BF16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", FP32_GN)
def test_groupnorm_silu_grad_fp32_unets_on_card(cuda_device, h, w, c):
    rng = np.random.default_rng(c)
    x = torch.from_numpy((rng.normal(size=(1, h, w, c)) * 2).astype(np.float32)).to(cuda_device)
    scale = torch.ones(c, device=cuda_device) * 1.1
    bias = torch.full((c,), 0.1, device=cuda_device)
    got, want = grad_pair(lambda a, s, b: hk.groupnorm_silu(a, s, b),
                          lambda a, s, b: hk.groupnorm_silu_plain(a, s, b), (x, scale, bias), seed=c)
    _assert_grads_close(got, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("t,heads", CHAIRS_ATTN)
def test_attention_grad_chairs_on_card(cuda_device, t, heads, n):
    """d/d(qkv) through ``attention_qkv`` (wgmma kernel forward) against
    autograd through ``dense_qkv_attention``, bf16 at batch 1 and 8: within
    1e-2 of the largest gradient; one forward launch, none in the backward."""
    rng = np.random.default_rng(t + n)
    qkv = torch.from_numpy(rng.normal(size=(n, t, heads * 3 * 64)).astype(np.float32))
    qkv = qkv.to(cuda_device, BF16)
    before = dict(hk.LAUNCHES)
    got, want = grad_pair(lambda q: hk.attention_qkv(q, heads),
                          lambda q: dense_qkv_attention(q, heads), (qkv,), seed=t)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["attention"] == before["attention"] + 1
    assert hk.LAUNCHES["attention_generic"] == before["attention_generic"]
    _assert_grads_close(got, want, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("t,heads,ch", FP32_ATTN)
def test_attention_generic_grad_on_card(cuda_device, t, heads, ch, n):
    rng = np.random.default_rng(ch + n)
    qkv = torch.from_numpy(rng.normal(size=(n, t, heads * 3 * ch)).astype(np.float32)).to(cuda_device)
    before = dict(hk.LAUNCHES)
    got, want = grad_pair(lambda q: hk.attention_qkv(q, heads),
                          lambda q: dense_qkv_attention(q, heads), (qkv,), seed=ch)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["attention_generic"] == before["attention_generic"] + 1
    _assert_grads_close(got, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("t,heads,ch", HEADS_BY_COUNT_ATTN)
def test_attention_generic_grad_heads_by_count_on_card(cuda_device, t, heads, ch, n):
    """The drag step's path at the heads-by-count shapes: the generic
    kernel's forward, the plain recompute backward, within 1e-2 of the
    largest gradient (bf16); one forward launch, none in the backward."""
    rng = np.random.default_rng(ch + n)
    qkv = torch.from_numpy(rng.normal(size=(n, t, heads * 3 * ch)).astype(np.float32))
    qkv = qkv.to(cuda_device, BF16)
    before = dict(hk.LAUNCHES)
    got, want = grad_pair(lambda q: hk.attention_qkv(q, heads),
                          lambda q: dense_qkv_attention(q, heads), (qkv,), seed=ch)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["attention_generic"] == before["attention_generic"] + 1
    assert hk.LAUNCHES["attention"] == before["attention"]
    _assert_grads_close(got, want, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("res,seed", [(48, 0), (96, 1)])
def test_device_marching_on_card_matches_cpu(cuda_device, res, seed):
    """``ops/marching.py`` on a CUDA grid against the same function on the
    CPU: equal counts, the same triangles in the same order (the same keys,
    weld and compaction; corners compared as sets, since fused multiply-adds
    on the card may flip the winding of a triangle whose normal is nearly
    orthogonal to the gradient), signed volume to a relative 1e-6, vertices
    to 1e-9 voxel (fp64 from the same fp32 t)."""
    from ishapediting_tpu_torch.ops.marching import marching_tets_device

    rng = np.random.default_rng(seed)
    x = np.linspace(-1, 1, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    g = (0.5 - np.sqrt(X**2 + 1.3 * Y**2 + 0.7 * Z**2) + 0.1 * np.sin(6 * X) * np.cos(5 * Z)
         + 0.05 * rng.normal(size=X.shape)).astype(np.float32)
    cpu = marching_tets_device(torch.from_numpy(g))
    dev = marching_tets_device(torch.from_numpy(g).to(cuda_device))
    assert dev["vertices"].is_cuda and dev["triangles"].is_cuda
    assert (dev["n_cells"], dev["n_tris"]) == (cpu["n_cells"], cpu["n_tris"]) and cpu["n_tris"] > 0
    dt, ct = dev["triangles"].cpu(), cpu["triangles"]
    torch.testing.assert_close(dt.sort(dim=1).values, ct.sort(dim=1).values, atol=0, rtol=0)
    torch.testing.assert_close(dev["vertices"].cpu(), cpu["vertices"], atol=1e-9, rtol=0)

    def volume(v, t):
        v = v.cpu().double()
        return float((v[t[:, 0]] * torch.linalg.cross(v[t[:, 1]], v[t[:, 2]])).sum()) / 6

    assert volume(dev["vertices"], dt) == pytest.approx(volume(cpu["vertices"], ct), rel=1e-6)
