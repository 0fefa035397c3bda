"""Real-shape fitting (mesh -> triplane latent) and latent -> physical
triplanes.

``fit_guided`` is the classifier-guided DDPM reconstruction (reference:
drag_utils.py:401-471): at every sampling step the BCE between the decoded
occupancy of the *predicted x0* and the mesh's occupancy labels is
differentiated back through the decoder and the UNet to the latent and
applied as guidance. Each step draws a fresh ``batch_points`` batch from the
labeled point pool. Occupancy labeling is host-side (geometry/occupancy).

Channel groups of a latent are contiguous: plane p <- channels
[C/3*p, C/3*(p+1)) (reference: drag_utils.py:295,449-450).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ishapediting_tpu_torch.config import FitConfig
from ishapediting_tpu_torch.core.diffusion import guided_sample_loop, p_sample_guidance
from ishapediting_tpu_torch.core.schedule import Schedule
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.geometry.occupancy import points_occupancy
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder, decode_points


def latents_to_planes(latents: torch.Tensor, half_range: torch.Tensor, middle: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] normalized latents -> [B, 3, H, W, C/3] physical planes."""
    tri = latents * half_range + middle
    b, h, w, c = tri.shape
    return tri.reshape(b, h, w, 3, c // 3).permute(0, 3, 1, 2, 4)


def latent_to_planes(latent: torch.Tensor, half_range: torch.Tensor, middle: torch.Tensor) -> torch.Tensor:
    """[1, H, W, C] normalized latent -> [3, H, W, C/3] physical planes."""
    return latents_to_planes(latent, half_range, middle)[0]


def sample_training_points(mesh: TriMesh, cfg: FitConfig, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """50% uniform in [-1,1]^3 + 50% near-surface with sigma=0.01 jitter,
    occupancy-labeled (reference: drag_utils.py:431-437); the JAX package's
    NumPy draws, so the same seed gives the same points."""
    rng = np.random.default_rng(seed)
    n_uniform = int(cfg.points_size * cfg.points_uniform_ratio)
    uniform = (rng.random((n_uniform, 3)) * 2 - 1).astype(np.float32)
    surface = mesh.sample_points_uniformly(cfg.points_size - n_uniform, seed=seed + 1).astype(np.float32)
    surface = surface + cfg.surface_jitter * rng.standard_normal(surface.shape).astype(np.float32)
    points = np.concatenate([uniform, surface], axis=0)
    occ = points_occupancy(mesh, points).astype(np.float32)
    return points, occ


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean BCEWithLogits, numerically stable."""
    return (logits.clamp(min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))).mean()


def fit_guided(
    sched: Schedule,
    model_fn: Callable,
    decoder: TriplaneDecoder,
    points: torch.Tensor,  # [P, 3] or [B, P, 3]
    occupancies: torch.Tensor,  # [P] or [B, P]
    half_range: torch.Tensor,
    middle: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    latent_shape: Tuple[int, int, int],
    batch_points: int = 40_000,
    scale: float = 600.0,
    clip_denoised: bool = True,
    x_T: Optional[torch.Tensor] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    batch_indices: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Classifier-guided reconstruction; returns the fitted normalized
    latents [B, H, W, C]. With a leading shape axis on ``points`` B shapes
    fit together, each with its own BCE term (summed).

    Randomness comes from ``generator`` (x_T, then per step the point batch
    and the step noise); ``x_T``, ``noises[i]`` and ``batch_indices[i]``
    ([B, batch_points] indices into the pool) replace those draws, to replay
    a run of another implementation."""
    if points.ndim == 2:
        points, occupancies = points[None], occupancies[None]
    dev = points.device
    b, p_total = points.shape[0], points.shape[1]
    if x_T is None:
        x_T = torch.randn((b,) + tuple(latent_shape), generator=generator, device=dev)

    def guidance(img, tb, i):
        if batch_indices is None:
            idx = torch.randint(0, p_total, (b, batch_points), generator=generator, device=dev)
        else:
            idx = torch.as_tensor(batch_indices[i], device=dev).long()
        coords = torch.gather(points, 1, idx[..., None].expand(-1, -1, 3))
        labels = torch.gather(occupancies, 1, idx)[..., None]
        noise = None if noises is None else torch.as_tensor(noises[i], dtype=torch.float32, device=dev)
        im = img.detach().requires_grad_(True)
        with torch.enable_grad():
            out = p_sample_guidance(sched, model_fn, im, tb, generator, noise=noise,
                                    clip_denoised=clip_denoised)
            planes = latents_to_planes(out["pred_xstart"], half_range, middle)
            loss = -sum(
                bce_with_logits(decode_points(decoder, planes[k], coords[k]), labels[k])
                for k in range(b)
            )
        (grad,) = torch.autograd.grad(loss, im)
        return scale * grad, out["sample"].detach(), out["variance"].detach()

    return guided_sample_loop(sched, x_T, guidance_fn=guidance)
