"""Batch generation on one device (the JAX package's data-parallel loop,
reference loop: generate.py:72-84 + image_sample.py:168-190). Spreading the
batch over several GPUs waits for a later slice."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ishapediting_tpu_torch.core.diffusion import (
    ddim_sample_loop,
    dpm_solver_sample_loop,
    p_sample_loop,
)
from ishapediting_tpu_torch.core.schedule import Schedule

SAMPLERS = ("ddpm", "ddim", "dpm")


@torch.no_grad()
def sample_batches(
    sched: Schedule,
    model_fn: Callable,
    *,
    num_samples: int,
    batch_size: int,
    latent_shape,
    device,
    seed: int = 0,
    sampler: str = "ddpm",
    clip_denoised: bool = True,
    on_batch: Optional[Callable[[int, int], None]] = None,
) -> np.ndarray:
    """Sample ``num_samples`` latents in batches of ``batch_size``. Batch i
    draws x_T from a generator seeded with ``seed + i`` and, for the
    stochastic sampler, its step noise from the same generator. Returns the
    normalized latents [num_samples, H, W, C] as a NumPy array."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} ({'|'.join(SAMPLERS)})")
    samples = []
    done, batch_idx = 0, 0
    while done < num_samples:
        n = min(batch_size, num_samples - done)
        gen = torch.Generator(device=device).manual_seed(seed + batch_idx)
        x_T = torch.randn((n,) + tuple(latent_shape), generator=gen, device=device)
        if sampler == "ddim":
            x = ddim_sample_loop(sched, model_fn, x_T, gen, clip_denoised=clip_denoised)
        elif sampler == "dpm":
            x = dpm_solver_sample_loop(sched, model_fn, x_T, clip_denoised=clip_denoised)
        else:
            x = p_sample_loop(sched, model_fn, x_T, gen, clip_denoised=clip_denoised)
        samples.append(x.cpu().numpy())
        done += n
        batch_idx += 1
        if on_batch is not None:
            on_batch(batch_idx, done)
    return np.concatenate(samples, axis=0)
