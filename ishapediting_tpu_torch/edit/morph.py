"""Latent-space shape morphing (the JAX package's extension; the reference
ships ``ddim_reverse_sample`` with no loop or caller,
gaussian_diffusion.py:718-761).

Shapes are embedded in the diffusion noise space with the deterministic DDIM
reverse ODE (``core.diffusion.ddim_reverse_sample_loop``), interpolated there
with spherical lerp (noise vectors lie near a Gaussian shell, and slerp keeps
the norm that a linear mix shrinks), and decoded with DDIM at eta 0. Both
endpoints encode as one batch-2 walk and all K frames decode as one batch-K
walk.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import torch

from ishapediting_tpu_torch.core.diffusion import ddim_reverse_sample_loop, ddim_sample_loop
from ishapediting_tpu_torch.core.schedule import Schedule


def slerp(a: torch.Tensor, b: torch.Tensor, alpha) -> torch.Tensor:
    """Spherical interpolation of flattened latents; ``alpha`` is a scalar
    or a [K] batch of mix weights ([K] -> [K, *a.shape]). A zero endpoint
    has no direction: the norms are clamped, so the cosine is 0 (a quarter
    circle toward the other endpoint). (Anti-)parallel endpoints fall back
    to lerp."""
    a32 = a.float().reshape(-1)
    b32 = b.float().reshape(-1)
    na = torch.linalg.vector_norm(a32).clamp(min=1e-12)
    nb = torch.linalg.vector_norm(b32).clamp(min=1e-12)
    cos = torch.dot(a32 / na, b32 / nb).clamp(-1.0, 1.0)
    theta = torch.arccos(cos)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=a32.device)
    w = alpha.reshape(alpha.shape + (1,))
    sin = torch.sin(theta)
    safe = sin.abs() > 1e-6
    denom = torch.where(safe, sin, torch.ones_like(sin))
    wa = torch.where(safe, torch.sin((1 - w) * theta) / denom, 1 - w)
    wb = torch.where(safe, torch.sin(w * theta) / denom, w)
    return (wa * a32 + wb * b32).reshape(alpha.shape + a.shape)


def morph_latents(
    sched: Schedule,
    model_fn,
    x0_a: torch.Tensor,
    x0_b: torch.Tensor,
    alphas: Sequence[float],
    *,
    clip_denoised: bool = True,
    walls: Optional[Dict[str, float]] = None,
) -> torch.Tensor:
    """Morph between two clean latents [H, W, C] (or [1, H, W, C]): returns
    the decoded latents [K, H, W, C] at the mix weights ``alphas`` (0 -> a,
    1 -> b; the endpoints are DDIM round trips of the inputs). ``walls``, if
    given, receives ``encode_s`` and ``decode_s`` (device work included)."""
    x0_a = torch.as_tensor(x0_a, dtype=torch.float32)
    x0_b = torch.as_tensor(x0_b, dtype=torch.float32).to(x0_a.device)
    if x0_a.ndim == 3:
        x0_a, x0_b = x0_a[None], x0_b[None]

    def sync():
        if x0_a.device.type == "cuda":
            torch.cuda.synchronize(x0_a.device)

    t0 = time.perf_counter()
    noises = ddim_reverse_sample_loop(sched, model_fn, torch.cat([x0_a, x0_b]),
                                      clip_denoised=clip_denoised)
    mixed = slerp(noises[0], noises[1], list(alphas))
    if walls is not None:
        sync()
        walls["encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = ddim_sample_loop(sched, model_fn, mixed, eta=0.0, clip_denoised=clip_denoised)
    if walls is not None:
        sync()
        walls["decode_s"] = time.perf_counter() - t0
    return out
