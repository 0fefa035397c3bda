"""Batch generation over the ranks of a data axis (the JAX package's
``parallel/sampling.py``; reference loop: generate.py:72-84 +
image_sample.py:138-201).

Each trajectory is independent, so a batch splits over the ranks with no
traffic during the walk and one gather at its end. Every rank draws x_T,
and for a stochastic sampler each step's noise, for the whole batch from
the batch's generator, in the order one rank draws them, and keeps its own
rows: the gathered batch equals the one-rank run on the same device type,
whatever the number of ranks (the JAX package's sharded draw gives it the
same property).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ishapediting_tpu_torch.core.diffusion import (
    ddim_sample_loop,
    dpm_solver_sample_loop,
    p_sample_loop,
)
from ishapediting_tpu_torch.core.schedule import Schedule
from ishapediting_tpu_torch.parallel.mesh import DataMesh, broadcast_flat, gather, make_mesh, world
from ishapediting_tpu_torch.utils.trace import span

SAMPLERS = ("ddpm", "ddim", "dpm")


class RowDraws:
    """``draws[i]``: the rows ``rows`` of step i's normals of the whole
    batch ``shape``, drawn from ``generator`` when a loop asks for them. The
    loops ask for step i once, in loop order, so the draws follow the
    generator's one-rank order. ``noises`` (whole-batch, per step) replace
    the draws."""

    def __init__(self, generator: Optional[torch.Generator], shape, rows: slice, device,
                 noises: Optional[Sequence] = None):
        if generator is None and noises is None:
            raise ValueError("need a generator when no noises are given")
        self.generator, self.shape, self.rows, self.device = generator, tuple(shape), rows, device
        self.noises = noises

    def __getitem__(self, i: int) -> torch.Tensor:
        if self.noises is not None:
            full = torch.as_tensor(self.noises[i], dtype=torch.float32, device=self.device)
        else:
            full = torch.randn(self.shape, generator=self.generator, device=self.device)
        return full[self.rows]


@torch.no_grad()
def sample_sharded(
    sched: Schedule,
    model_fn: Callable,
    mesh: DataMesh,
    *,
    batch_size: int,
    latent_shape,
    generator: Optional[torch.Generator] = None,
    sampler: str = "ddpm",
    eta: float = 0.0,
    clip_denoised: bool = True,
    x_T: Optional[torch.Tensor] = None,
    noises: Optional[Sequence] = None,
) -> torch.Tensor:
    """Sample ``batch_size`` trajectories split over the mesh's data axis;
    returns the whole batch [B, H, W, C], fp32, on every rank of the axis.

    ``sampler``: "ddpm" (ancestral), "ddim" (``eta`` 0 is deterministic) or
    "dpm" (DPM-Solver++(2M), deterministic). x_T comes from ``generator``
    (or ``x_T``, the whole batch), then each stochastic step's noise (or
    ``noises[i]``, the whole batch of loop step i)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} ({'|'.join(SAMPLERS)})")
    rows = mesh.rows(batch_size)
    shape = (batch_size,) + tuple(latent_shape)
    dev = mesh.device
    if x_T is None:
        if generator is None:
            raise ValueError("need a generator when no x_T is given")
        x_T = torch.randn(shape, generator=generator, device=dev)
    x = torch.as_tensor(x_T, dtype=torch.float32).to(dev)[rows]
    stochastic = sampler == "ddpm" or (sampler == "ddim" and eta != 0.0)
    draws = RowDraws(generator, shape, rows, dev, noises) if stochastic else None
    if sampler == "ddim":
        out = ddim_sample_loop(sched, model_fn, x, eta=eta, noises=draws, clip_denoised=clip_denoised)
    elif sampler == "dpm":
        out = dpm_solver_sample_loop(sched, model_fn, x, clip_denoised=clip_denoised)
    else:
        out = p_sample_loop(sched, model_fn, x, noises=draws, clip_denoised=clip_denoised)
    return gather(out, mesh)


def plan_data_mesh(batch_size: int, device=None) -> Tuple[DataMesh, int]:
    """The largest data axis whose rank count divides ``batch_size``:
    (mesh, usable ranks). Shared by every batch-generation surface so their
    sharding cannot drift apart; every rank must call it."""
    n_world, _ = world()
    usable = max(1, min(n_world, batch_size))
    while batch_size % usable:
        usable -= 1
    return make_mesh(usable, device=device), usable


def batch_plan(num_samples: int, batch_size: int, usable: int, data_size: int) -> List[Tuple[int, bool]]:
    """The batches of ``sample_batches``: (samples, on the data axis) per
    batch. A batch holds ``batch_size`` samples, or what remains; one of
    ``usable`` or more is rounded down to a multiple of ``usable``, a smaller
    remainder runs on rank 0 alone, as does any batch the data axis of
    ``data_size`` ranks does not divide (the JAX package's plan)."""
    plan, remaining = [], num_samples
    while remaining > 0:
        n = min(batch_size, remaining) if remaining >= usable else remaining
        n = max(n - n % usable, usable) if n >= usable else n
        plan.append((n, n % data_size == 0))
        remaining -= n
    return plan


def _to_world(x: Optional[torch.Tensor], shape, mesh: DataMesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank of the world, where the mesh that made
    it does not span the world (its other ranks pass None)."""
    n_world, _ = world()
    if n_world == mesh.n_ranks:
        return x
    if x is None:
        x = torch.empty(shape, device=mesh.device)
    broadcast_flat([x])
    return x


@torch.no_grad()
def sample_batches(
    sched: Schedule,
    model_fn: Callable,
    *,
    num_samples: int,
    batch_size: int,
    latent_shape,
    device=None,
    seed: int = 0,
    sampler: str = "ddpm",
    clip_denoised: bool = True,
    mesh: Optional[DataMesh] = None,
    usable: Optional[int] = None,
    on_batch: Optional[Callable[[int, int], None]] = None,
) -> np.ndarray:
    """Sample ``num_samples`` latents in the batches of ``batch_plan``; batch
    i draws from a generator seeded with ``seed + i`` and splits over the
    data axis of ``mesh`` (default ``plan_data_mesh(batch_size)``: one rank
    without a process group). ``usable`` defaults to the mesh's rank count
    (the JAX package's ``sample_batches`` raises TypeError there). Every
    rank of the world calls it and gets the normalized latents
    [num_samples, H, W, C] as a NumPy array. ``on_batch(batch_idx, done)``
    fires after each batch. On a mesh with a model axis every rank of a
    data index samples the same rows, and a batch off the data axis runs
    on the ranks of data index 0."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} ({'|'.join(SAMPLERS)})")
    if mesh is None:
        mesh, usable = plan_data_mesh(batch_size, device=device)
    elif usable is None:
        usable = mesh.size
    single = make_mesh(mesh.model, model_parallel=mesh.model, device=mesh.device)
    samples, done = [], 0
    for batch_idx, (n, on_axis) in enumerate(batch_plan(num_samples, batch_size, usable, mesh.size)):
        m = mesh if on_axis else single
        out = None
        if m.active:
            gen = torch.Generator(device=m.device).manual_seed(seed + batch_idx)
            out = sample_sharded(sched, model_fn, m, batch_size=n, latent_shape=latent_shape,
                                 generator=gen, sampler=sampler, clip_denoised=clip_denoised)
        out = _to_world(out, (n,) + tuple(latent_shape), m)
        with span("to_host"):
            samples.append(out.cpu().numpy())
        done += n
        if on_batch is not None:
            on_batch(batch_idx + 1, done)
    return np.concatenate(samples, axis=0)
