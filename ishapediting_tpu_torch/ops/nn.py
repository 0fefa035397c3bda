"""NN primitives for the ADM UNet over NHWC tensors, with the JAX package's
precision policy: fp32 GroupNorm statistics with the result cast back to the
input dtype, weights cast per op to the activation dtype.

An NHWC tensor here is exactly the memory of the NCHW tensor in
``torch.channels_last`` format, so ``conv2d`` hands cuDNN a channels_last
view with no copy, and the Hopper kernels read it as it is.

Every product (``conv2d``, ``linear``) is rounded to the activation dtype
before its bias, itself rounded to that dtype, is added, and a residual add
follows the rounded biased product, as in the JAX package: ``rnd(y +
rnd(b))``, then ``rnd(res + that)``, each add one fp32 add. The bias add
is the epilogue ``hopper_kernels.bias_epilogue`` (one hand-written kernel on
CUDA where no gradient is wanted, which reads the bias as stored and rounds
it itself; the plain composition on the CPU and under autograd);
``conv2d_product`` / ``linear_product`` return the
raw product, which a ResBlock or an attention block hands with its bias and
its residual to one fused epilogue (``add_bias_residual``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ishapediting_tpu_torch.utils.trace import span


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def effective_groups(c: int, num_groups: int) -> int:
    """The largest group count <= ``num_groups`` that divides ``c``. The
    published models always have c a multiple of 32; miniature test configs
    fall back to a smaller divisor."""
    g = min(num_groups, c)
    while c % g:
        g -= 1
    return g


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over NHWC input; statistics in fp32, output cast back to the
    input dtype (reference GroupNorm32: nn.py:16-18, 32 groups: nn.py:92-99)."""
    n, h, w, c = x.shape
    g = effective_groups(c, num_groups)
    xg = x.float().reshape(n, h, w, g, c // g)
    mean = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    out = xg.reshape(n, h, w, c) * scale.float() + bias.float()
    return out.to(x.dtype)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """2D convolution, NHWC x OIHW -> NHWC, computed in x.dtype. The bias,
    rounded to x.dtype, is added after the product is rounded to x.dtype,
    as in the JAX package (spans ``weight_cast``, ``conv`` or ``conv_fp32``,
    ``bias_add``)."""
    return add_bias(conv2d_product(x, w, stride, padding), b)


def conv2d_product(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``conv2d`` without its bias: the product rounded to x.dtype, NHWC, a
    fresh tensor."""
    w = _cast_weight(w, x.dtype)
    with span("conv_fp32" if x.dtype == torch.float32 else "conv"):
        out = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense layer; ``w`` stored (out, in). Computed in x.dtype, the bias
    added after the product is rounded (the JAX package's rounding points)."""
    return add_bias(linear_product(x, w), b)


def linear_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``linear`` without its bias: the product rounded to x.dtype, a fresh
    tensor."""
    w = _cast_weight(w, x.dtype)
    with span("linear"):
        return F.linear(x, w)


def _cast_weight(w, dtype):
    """The layer's weight in the activation dtype. Its bias is passed as
    stored: the bias epilogue rounds it to the activation dtype itself."""
    with span("weight_cast"):
        return w.to(dtype)


def add_bias(out, b):
    """``rnd(out + rnd(b))`` for a fresh product ``out`` (span
    ``bias_add``): the plain form of the bias epilogue, which may write into
    ``out``."""
    if b is None:
        return out
    from ishapediting_tpu_torch.ops import hopper_kernels as hk

    with span("bias_add"):
        return hk.bias_epilogue(out, b)


def add_bias_residual(y, b, res, res_bias=None):
    """``rnd(res + rnd(y + rnd(b)))`` for a fresh product ``y`` of
    ``res``'s shape (span ``residual``): the fused form of the bias
    epilogue, one launch on CUDA, which may write into ``y``. ``res_bias``:
    res is itself a raw product (a 1x1 skip convolution's) whose bias is
    added first, ``rnd(res + rnd(res_bias))``. ``b`` None (a cut layer, its
    bias added before the gather): ``rnd(res + y)``."""
    from ishapediting_tpu_torch.ops import hopper_kernels as hk

    with span("residual"):
        return hk.bias_epilogue(y, b, res, res_bias)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool over NHWC: fp32 window sum cast back, then
    scaled (reference Downsample with use_conv=False: unet.py:113-140)."""
    n, h, w, c = x.shape
    s = x.float().reshape(n, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))
    return s.to(x.dtype) * 0.25


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor 2x upsample over NHWC (reference Upsample:
    unet.py:100-110, F.interpolate mode='nearest')."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: int = 10000
) -> torch.Tensor:
    """Sinusoidal timestep embeddings, cos-first ordering
    (reference: nn.py:102-120). Always fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(0, half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def group_norm_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    film=None,
) -> torch.Tensor:
    """``silu(group_norm(x) [* (1 + film_scale) + film_shift])`` over NHWC
    input, the UNet's most common op chain (reference: unet.py:214-252).
    A CUDA tensor goes to the fused Hopper kernel, a CPU tensor to its plain
    composition (``ops/hopper_kernels.py``)."""
    from ishapediting_tpu_torch.ops import hopper_kernels as hk

    return hk.groupnorm_silu(x, scale, bias, num_groups, eps, film)


def channel_nearest_resize(x: torch.Tensor, new_c: int, dim: int = -1) -> torch.Tensor:
    """Nearest-neighbor resize along one axis with ``F.interpolate``'s index
    mapping floor(i * src / dst) (reference: drag_utils.py:146-151)."""
    src = x.shape[dim]
    pos = torch.arange(new_c, dtype=torch.float32) * torch.tensor(
        src / new_c, dtype=torch.float32
    )
    idx = torch.floor(pos).long().to(x.device)
    return torch.index_select(x, dim, idx)
