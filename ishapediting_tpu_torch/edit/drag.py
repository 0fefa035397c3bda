"""The drag-edit guidance step and loop (reference: drag_utils.py:302-399).

One edit step:

    grad = d/d(x_t) [ -motion_loss - cof * mask_loss ]   (autograd through
                                                          the whole UNet)
    x_{t-1} = sample(x_t) + variance(x_t) * scale * grad

where the losses compare the tapped UNet feature planes of the current latent
against the cached originals, sampled at the source/target neighborhoods
(motion) and outside them (mask regularization). The UNet's forward runs the
Hopper kernels on the card; their backward recomputes through the plain
versions (``ops/hopper_kernels.py``), as the JAX package's ``custom_vjp``
does, so a step launches each kernel once per forward call and none in the
backward pass.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ishapediting_tpu_torch.core.diffusion import p_sample_guidance
from ishapediting_tpu_torch.core.schedule import Schedule
from ishapediting_tpu_torch.edit.features import (
    complement_masks,
    neighborhood_points,
    plane_grids,
    regroup_features,
)
from ishapediting_tpu_torch.ops.grid_sample import grid_sample_2d
from ishapediting_tpu_torch.utils.trace import span


class DragProblem(NamedTuple):
    """Precomputed geometry of one drag request, on the device."""

    patch_grid: torch.Tensor  # [3, B, N1, 2]
    shift_grid: torch.Tensor  # [3, B, N1, 2]
    masks: torch.Tensor  # [3, s, s] complement masks
    mask_count: float  # total complement pixels across planes


def build_drag_problem(
    sources: np.ndarray,
    targets: np.ndarray,
    *,
    r1: int,
    voxel_size: float,
    feat_width: int,
    device=None,
) -> DragProblem:
    """Handle points -> plane grids + complement masks
    (reference: drag_utils.py:316-334)."""
    sources = np.asarray(sources, np.float32).reshape(-1, 3)
    targets = np.asarray(targets, np.float32).reshape(-1, 3)
    if sources.shape != targets.shape:
        raise ValueError("sources and targets must pair up")
    patch = neighborhood_points(sources, r1, voxel_size)
    shift = neighborhood_points(targets, r1, voxel_size)
    masks, count = complement_masks(patch, shift, feat_width)
    return DragProblem(
        patch_grid=torch.as_tensor(plane_grids(patch), device=device),
        shift_grid=torch.as_tensor(plane_grids(shift), device=device),
        masks=torch.as_tensor(masks, device=device),
        mask_count=count,
    )


def drag_losses(
    edit_feat: torch.Tensor,
    origin_feat: torch.Tensor,
    problem: DragProblem,
    loss_type: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(motion_loss, mask_loss), both scalars (reference: drag_utils.py:355-382).
    ``edit_feat``/``origin_feat``: [3, s, s, C] plane features; the losses
    run in fp32 whatever the cache's dtype."""
    edit_feat = edit_feat.float()
    origin_feat = origin_feat.float()
    c = edit_feat.shape[-1]
    patch_feature = grid_sample_2d(origin_feat, problem.patch_grid).detach()  # [3, B, N1, C]
    shift_feature = grid_sample_2d(edit_feat, problem.shift_grid)
    diff = edit_feat - origin_feat
    m = problem.masks[..., None]
    if loss_type == "l1":
        motion = (shift_feature - patch_feature).abs().mean()
        mask = (diff.abs() * m).sum() / (c * problem.mask_count)
    else:
        motion = (shift_feature - patch_feature).square().mean()
        mask = (diff.square() * m).sum() / (c * problem.mask_count)
    return motion, mask


def make_drag_step(
    sched: Schedule,
    model_fn_feat: Callable,
    problem: DragProblem,
    *,
    scale: float,
    cof: float,
    loss_type: str = "l2",
    clip_denoised: bool = True,
):
    """Build ``step(x_t, t, origin_feat, generator=None, *, noise=None,
    variance_override=None, variance_noise=None) -> (x_{t-1}, (motion, mask))``.

    ``model_fn_feat`` must return the tapped feature. The optional overrides
    are the reference's edit-mode variants (drag_utils.py:342-346, 388-390):
    ``variance_override`` keeps fresh noise with the inversion-recorded
    variance; ``variance_noise`` replays the recorded residual exactly.
    ``noise`` replaces the step's draw from ``generator``. The mask term is
    always computed (``cof`` only weights it), as in the JAX package."""

    def step(img, t, origin_feat, generator=None, *, noise=None,
             variance_override=None, variance_noise=None):
        im = img.detach().float().requires_grad_(True)
        tb = torch.full((im.shape[0],), int(t), dtype=torch.long, device=im.device)
        with torch.enable_grad():
            out = p_sample_guidance(
                sched, model_fn_feat, im, tb, generator, noise=noise,
                variance=variance_override, variance_noise=variance_noise,
                clip_denoised=clip_denoised,
            )
            with span("drag_loss"):
                edit_feat = regroup_features(out["inter_feat"])[0]  # [3, s, s, C]
                motion, mask = drag_losses(edit_feat, origin_feat, problem, loss_type)
                loss = -motion - cof * mask
        with span("drag_backward"):
            (grad,) = torch.autograd.grad(loss, im)
        with span("drag_update"):
            sample = out["sample"].detach()
            variance = out["variance"].detach()
            return sample + variance * (scale * grad), (motion.detach(), mask.detach())

    return step


def drag_edit_scan(
    sched: Schedule,
    model_fn_feat: Callable,
    problem: DragProblem,
    w_latent: torch.Tensor,
    features: torch.Tensor,  # [w_time, 3, s, s, C], index k <-> t = w_time-1-k
    generator: Optional[torch.Generator] = None,
    *,
    w_time: int,
    scale: float,
    cof: float,
    loss_type: str = "l2",
    t_stop: int = 0,
    noises: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """The full drag loop t = w_time-1 .. t_stop, one guided step after
    another; ``noises[i]`` replaces the draw of loop step i. Returns
    x_{t_stop}."""
    step = make_drag_step(sched, model_fn_feat, problem, scale=scale, cof=cof,
                          loss_type=loss_type)
    img = w_latent.float()
    for i, t in enumerate(range(w_time - 1, t_stop - 1, -1)):
        noise = None if noises is None else torch.as_tensor(noises[i], device=img.device)
        img, _ = step(img, t, features[i], generator, noise=noise)
    return img
