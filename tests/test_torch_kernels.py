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
