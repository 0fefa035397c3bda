"""ADM-style QKV self-attention for small token counts (<= 1024).

Semantics follow QKVAttentionLegacy (reference: unet.py:328-354): qkv comes
from a 1x1 projection with channel layout [heads * 3 * head_dim] (heads
outermost, q/k/v inner), logits use the double-sqrt scaling
``(q/ch^0.25) @ (k/ch^0.25)``, and the softmax runs in fp32.
"""

from __future__ import annotations

import torch


def dense_qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The plain composition, also the autograd oracle of the kernel.
    ``qkv``: [N, T, H*3*ch] (per-head q, k, v contiguous). Returns [N, T, H*ch]."""
    n, t, width = qkv.shape
    assert width % (3 * num_heads) == 0, (width, num_heads)
    ch = width // (3 * num_heads)
    q, k, v = qkv.reshape(n, t, num_heads, 3 * ch).chunk(3, dim=-1)

    scale = 1.0 / (ch ** 0.25)
    logits = torch.einsum("nthc,nshc->nhts", q * scale, k * scale)
    weights = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("nhts,nshc->nthc", weights.to(v.dtype), v)
    return out.reshape(n, t, num_heads * ch)


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Attention over a CUDA tensor by the Hopper kernel, over a CPU tensor
    by ``dense_qkv_attention`` (``ops/hopper_kernels.py``)."""
    from ishapediting_tpu_torch.ops import hopper_kernels as hk

    return hk.attention_qkv(qkv, num_heads)
