"""Real-shape fitting (mesh -> triplane latent) and latent -> physical
triplanes.

``fit_guided`` is the classifier-guided DDPM reconstruction (reference:
drag_utils.py:401-471): at every sampling step the BCE between the decoded
occupancy of the *predicted x0* and the mesh's occupancy labels is
differentiated back through the decoder and the UNet to the latent and
applied as guidance. Each step draws a fresh ``batch_points`` batch from the
labeled point pool. Occupancy labeling is host-side (geometry/occupancy).

``fit_direct`` is the direct alternative (reference: drag_utils.py:473-550):
Adam on the physical planes against BCE, a smoothness term, TV and L2; it
runs the decoder only.

Channel groups of a latent are contiguous: plane p <- channels
[C/3*p, C/3*(p+1)) (reference: drag_utils.py:295,449-450).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ishapediting_tpu_torch.config import FitConfig
from ishapediting_tpu_torch.core.diffusion import guided_sample_loop, p_sample_guidance
from ishapediting_tpu_torch.core.schedule import Schedule
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.geometry.occupancy import points_occupancy
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder, decode_points, l2_reg, tv_reg


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


def fit_direct(
    decoder: TriplaneDecoder,
    points: torch.Tensor,  # [P, 3]
    occupancies: torch.Tensor,  # [P]
    half_range: torch.Tensor,
    middle: torch.Tensor,
    means: Optional[np.ndarray],
    stds: Optional[np.ndarray],
    generator: Optional[torch.Generator],
    cfg: FitConfig,
    *,
    latent_shape: Tuple[int, int, int],
    init_noise: Optional[torch.Tensor] = None,
    draws: Optional[Sequence[Tuple]] = None,
    losses: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """Direct Adam fit of the physical planes (reference:
    drag_utils.py:473-550): ``opt_epochs * (P // batch_points)`` steps of
    ``torch.optim.Adam`` (lr ``opt_lr``, betas 0.9/0.999, the update rule of
    ``optax.adam``) on BCE + ``opt_smooth_weight`` * the squared logit change
    between random points and their 1e-2-jittered copies + ``opt_l2_weight``
    * ``l2_reg`` + ``opt_tv_weight`` * ``tv_reg``. The planes start at the
    category's ``means + stds * randn``, or ``randn * 1e-3`` without them.

    Draws come from ``generator``: the [1, H, W, C] init normals, then per
    step the point indices, the uniform coordinates and the jitter normals.
    ``init_noise`` and ``draws[i] = (indices [batch], uniform [batch, 3],
    normal [batch, 3])`` replace them, to replay another implementation's
    run. Each step's loss (before its update) is appended to ``losses``.
    Returns the normalized latent [1, H, W, C]."""
    h, w, c = latent_shape
    dev = points.device
    if init_noise is None:
        init_noise = torch.randn((1, h, w, c), generator=generator, device=dev)
    init = torch.as_tensor(init_noise, dtype=torch.float32, device=dev)
    if means is not None and stds is not None:
        init = init * torch.as_tensor(stds, device=dev) + torch.as_tensor(means, device=dev)
    else:
        init = init * 0.001  # the decoder-training plane init (axisnetworks.py:523)
    planes = init[0].reshape(h, w, 3, c // 3).permute(2, 0, 1, 3).contiguous().requires_grad_(True)
    opt = torch.optim.Adam([planes], lr=cfg.opt_lr, betas=(0.9, 0.999), eps=1e-8)
    p_total = points.shape[0]
    total_steps = cfg.opt_epochs * max(1, p_total // cfg.batch_points)
    shape = (cfg.batch_points, 3)
    for i in range(total_steps):
        if draws is None:
            idx = torch.randint(0, p_total, (cfg.batch_points,), generator=generator, device=dev)
            rand_coord = torch.rand(shape, generator=generator, device=dev) * 2.0 - 1.0
            jitter = torch.randn(shape, generator=generator, device=dev)
        else:
            idx, rand_coord, jitter = (torch.as_tensor(a, device=dev) for a in draws[i])
            idx, rand_coord, jitter = idx.long(), rand_coord.float(), jitter.float()
        coords = points[idx]
        labels = occupancies[idx][:, None]
        with torch.enable_grad():
            loss = bce_with_logits(decode_points(decoder, planes, coords), labels)
            pred_a = decode_points(decoder, planes, rand_coord)
            pred_b = decode_points(decoder, planes, rand_coord + 1e-2 * jitter)
            loss = loss + cfg.opt_smooth_weight * (pred_a - pred_b).square().mean()
            loss = loss + cfg.opt_l2_weight * l2_reg(planes)
            loss = loss + cfg.opt_tv_weight * tv_reg(planes)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        opt.step()
        if losses is not None:
            losses.append(loss.detach())
    tri = planes.detach().permute(1, 2, 0, 3).reshape(1, h, w, c)
    return (tri - middle) / half_range
